"""Plain PyTorch megastep: the CUDA kernel's reference (port of
`repro.kernels.envstep.ref` and of `megastep.py::fused_transition`).

Same row-major layout and step order as csrc/megastep.cu, written as a
Python loop over the K steps, over fresh reset rows precomputed for the K
steps, as the TPU kernel takes them; the CUDA kernel computes those resets
itself from the lanes' keys. After `ops.fresh_rows`, it is the CPU path of
every fused pool and what the kernel is held against on the card
(chip_smoke.py).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def fused_transition(step_rows: Callable, rows, act, fresh, fresh_obs,
                     s_env: int, max_steps: Optional[int]):
    """One fused step on row-major state: dynamics + TimeLimit + AutoReset.

    rows (S', B), act (B,), fresh (S', B), fresh_obs (O, B), all float32.
    Returns (new_rows, obs, terminal_obs, reward, done, truncated), in the
    order of `AutoReset(TimeLimit(env)).step`: `truncated` uses the env's
    own `done` before the time-limit fold, and `terminal_obs` is the
    pre-reset observation.
    """
    stepped, obs, reward, done = step_rows(rows[:s_env], act)
    trunc = torch.zeros_like(done)
    if max_steps is not None:
        tcnt = rows[s_env:s_env + 1] + 1.0
        hit = (tcnt[0] >= float(max_steps)).to(torch.float32)
        trunc = hit * (1.0 - done)
        done = torch.maximum(done, hit)
        stepped = torch.cat([stepped, tcnt], 0)
    reset = done > 0.0
    new_rows = torch.where(reset, fresh, stepped)
    obs_out = torch.where(reset, fresh_obs, obs)
    return new_rows, obs_out, obs, reward, done, trunc


def megastep_ref(step_rows: Callable, state, actions, fresh, fresh_obs, *,
                 max_steps: Optional[int] = None):
    """K fused steps over precomputed resets: `megastep_cuda`'s outputs
    but its final keys, which `ops.fresh_rows` gives beside `fresh`.

    state (S', B), actions (K, B), fresh (K, S', B), fresh_obs (K, O, B).
    Returns (new_state (S', B), obs (K, O, B), terminal_obs (K, O, B),
    reward (K, B), done (K, B), truncated (K, B)), all float32.
    """
    s_env = state.shape[0] - (1 if max_steps is not None else 0)
    rows = state.to(torch.float32)
    outs = []
    for t in range(actions.shape[0]):
        rows, *out = fused_transition(
            step_rows, rows, actions[t].to(torch.float32),
            fresh[t].to(torch.float32), fresh_obs[t].to(torch.float32),
            s_env, max_steps)
        outs.append(out)
    obs, tobs, reward, done, trunc = (torch.stack(x) for x in zip(*outs))
    return rows, obs, tobs, reward, done, trunc


__all__ = ["fused_transition", "megastep_ref"]
