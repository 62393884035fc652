"""Public megastep API: backend dispatch + the wrapper-stack adapter
(port of `repro.kernels.envstep.ops`).

`env_megastep` is the row-level op: "cuda" launches the kernel, "torch"
runs the plain version, "auto" picks the kernel for CUDA tensors and the
plain version for CPU tensors. Nothing falls back: a CUDA tensor given to
"cuda" or "auto" launches the kernel or raises.

`fused_step` is what `Env.fused_step` and the pool call. It takes the
batched `AutoResetState` that `Vec(AutoReset(env))` carries, precomputes the
auto-reset key chain and the K fresh reset states with the same `split` +
`reset` sequence `AutoReset.step` makes every step (so the threefry stream
matches the per-step path bit for bit), flattens the state to rows, runs
the megastep and rebuilds the state.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import random as R
from repro_torch.kernels.envstep.megastep import megastep_cuda
from repro_torch.kernels.envstep.ref import megastep_ref
from repro_torch.kernels.envstep.specs import lookup

BACKENDS = ("auto", "cuda", "torch")


def env_megastep(spec, state, actions, fresh, fresh_obs, *,
                 max_steps: Optional[int] = None, backend: str = "auto"):
    """Row-level K-step fused op with backend dispatch (see the module doc).

    `spec` is the env's `FusedSpec`: its `kernel_id` picks the CUDA body,
    its `step_rows` drives the plain version.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "cuda" or (backend == "auto" and state.is_cuda):
        return megastep_cuda(spec.kernel_id, state, actions, fresh, fresh_obs,
                             max_steps=max_steps)
    return megastep_ref(spec.step_rows, state, actions, fresh, fresh_obs,
                        max_steps=max_steps)


def supports(env) -> bool:
    """True if `env` (a base env or TimeLimit(base)) has a fused path."""
    return lookup(env) is not None


def state_rows(spec, max_steps, wrapped):
    """A (TimeLimit-wrapped) state as megastep rows (..., S', B); the step
    counter is the last row when there is a TimeLimit."""
    if max_steps is None:
        return spec.flatten(wrapped)
    return torch.cat([spec.flatten(wrapped.inner),
                      wrapped.t.to(torch.float32).unsqueeze(-2)], -2)


def fresh_rows(env, keys: torch.Tensor, num_steps: int):
    """The auto-reset key chain and fresh reset rows for `num_steps` steps.

    Per step, `split(key)` gives the next chain key and a reset key, as in
    `AutoReset.step`. The chain is sequential; the K resets are one batched
    `reset` over (K, B) keys. Returns (final_keys (B, 2),
    fresh_rows (K, S', B), fresh_obs_rows (K, O, B)), contiguous.
    """
    spec, max_steps = lookup(env)
    reset_keys = []
    for _ in range(num_steps):
        pair = R.split(keys)
        keys = pair[..., 0, :]
        reset_keys.append(pair[..., 1, :])
    fresh_states, fresh_obs = env.reset(torch.stack(reset_keys))
    return (keys, state_rows(spec, max_steps, fresh_states).contiguous(),
            fresh_obs.transpose(-1, -2).contiguous())


def fused_step(env, state, actions, num_steps: Optional[int] = None, *,
               backend: str = "auto", active=None):
    """Advance a batched `AutoReset(env)` state by K fused steps.

    env     : the single-env stack the pool holds, `TimeLimit(base)` or base.
    state   : `AutoResetState` with batched (B,) leaves.
    actions : (K, B) (discrete) or (K, B, 1) (continuous) action block.

    Returns `(new_state, ts)`: `ts` is a `Timestep` whose obs / reward /
    done / info leaves carry a leading (K, ...) step axis, as K iterated
    `AutoReset(env).step` calls would give. `info` has `terminal_obs` and,
    with a TimeLimit, `truncated`.
    """
    from repro_torch.core.env import Timestep
    from repro_torch.core.wrappers import AutoResetState, TimeLimitState

    if active is not None:
        raise NotImplementedError(
            "active= lane masks come with the async pool (ROADMAP A11)")
    found = lookup(env)
    if found is None:
        raise NotImplementedError(
            f"no fused megastep spec for {env!r}; supported: CartPole, "
            "MountainCar, Pendulum, Acrobot, bare or under one TimeLimit "
            "(pixel stacks come with the pixel slice, ROADMAP A8; the grid, "
            "puzzle and arcade bodies with theirs, ROADMAP B1)")
    spec, max_steps = found

    acts = actions
    if acts.dim() == 3 and acts.shape[-1] == 1:
        acts = acts[..., 0]
    if acts.dim() != 2:
        raise ValueError(f"actions must be (K, B[, 1]); got {tuple(actions.shape)}")
    k = acts.shape[0]
    if num_steps is not None and num_steps != k:
        raise ValueError(f"num_steps={num_steps} != actions.shape[0]={k}")

    final_keys, fresh, fobs = fresh_rows(env, state.key, k)
    rows = state_rows(spec, max_steps, state.inner).contiguous()
    new_rows, obs, tobs, reward, done, trunc = env_megastep(
        spec, rows, acts.to(torch.float32).contiguous(), fresh, fobs,
        max_steps=max_steps, backend=backend)

    inner = spec.unflatten(new_rows[:spec.state_size])
    info = {}
    if max_steps is not None:
        inner = TimeLimitState(inner, new_rows[spec.state_size].to(torch.int32))
        info["truncated"] = trunc.to(torch.bool)
    info["terminal_obs"] = tobs.transpose(-1, -2)
    new_state = AutoResetState(inner, final_keys)
    return new_state, Timestep(state=new_state, obs=obs.transpose(-1, -2),
                               reward=reward, done=done.to(torch.bool),
                               info=info)


__all__ = ["BACKENDS", "env_megastep", "fresh_rows", "fused_step",
           "state_rows", "supports"]
