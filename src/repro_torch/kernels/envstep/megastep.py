"""CUDA megastep: K fused environment steps per kernel launch.

The port of the Pallas TPU kernel
`src/repro/kernels/envstep/megastep.py::megastep_pallas`. The kernel itself
is hand-written CUDA C++ for sm_90a in `csrc/megastep.cu` (design and bound
in its header); this module is its wrapper: it checks the operands,
allocates the outputs, launches on PyTorch's current stream and counts the
launches. It takes only CUDA tensors and raises on anything else. Unlike
the TPU kernel it takes the lanes' auto-reset keys, not precomputed fresh
states: the kernel splits each lane's key every step and runs the env's
reset where an episode ends. Its plain version for the CPU is
`ops.fresh_rows` (the key chain and the resets) followed by
`ref.megastep_ref`, chosen by `ops.env_megastep`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import random as R


class Body(NamedTuple):
    kernel_id: int      # the `body` switch in csrc/megastep.cu
    state_size: int     # S
    obs_size: int       # O
    # the env attributes the body compiles in, as (name, value) pairs: its
    # grid sizes and LightsOut's scramble presses
    params: Tuple[Tuple[str, int], ...] = ()


#: the kernel's env bodies, by env class name; must match csrc/megastep.cu
BODIES = {
    "CartPole": Body(0, 4, 4),
    "MountainCar": Body(1, 2, 2),
    "Pendulum": Body(2, 2, 3),
    "Acrobot": Body(3, 4, 6),
    "Pong": Body(4, 6, 6),
    "Breakout": Body(5, 29, 29),
    "LightsOut": Body(6, 26, 25, (("n", 5), ("scramble_presses", 6))),
    "FrozenLake": Body(7, 17, 16, (("n", 4),)),
    "CliffWalk": Body(8, 49, 48, (("n_rows", 4), ("n_cols", 12))),
    "Maze": Body(9, 66, 64, (("n", 8),)),
    "Snake": Body(10, 76, 36, (("n", 6),)),
}
_BY_ID = {b.kernel_id: b for b in BODIES.values()}


def _bind(lib: ctypes.CDLL):
    """lib's C entry point `megastep`, typed."""
    fn = lib.megastep
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 11
        fn.restype = ctypes.c_int
    return fn


def _library():
    from repro_torch.kernels.build import load

    return _bind(load("megastep"))


def megastep_cuda(kernel_id: int, state: torch.Tensor, keys: torch.Tensor,
                  actions: torch.Tensor, *, max_steps: Optional[int] = None):
    """Run K fused env steps over the batch as one CUDA launch.

    state (S', B) and actions (K, B) contiguous float32, keys (B, 2) the
    lanes' auto-reset keys (int64 holding uint32 words, contiguous), on one
    CUDA device, with S' = S + 1 (the step counter row) when `max_steps` is
    given. Returns (new_state (S', B), final_keys (B, 2), obs (K, O, B),
    terminal_obs (K, O, B), reward (K, B), done (K, B), truncated (K, B)),
    float32 but for the keys.
    """
    if kernel_id not in _BY_ID:
        raise ValueError(f"no megastep kernel body {kernel_id}")
    body = _BY_ID[kernel_id]
    operands = {"state": (state, torch.float32), "keys": (keys, R.KEY_DTYPE),
                "actions": (actions, torch.float32)}
    for what, (x, dtype) in operands.items():
        if not x.is_cuda:
            raise ValueError(f"megastep_cuda takes CUDA tensors; {what} is on "
                             f"{x.device}")
        if x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"megastep_cuda takes contiguous {dtype} {what}; "
                             f"got {x.dtype}, contiguous={x.is_contiguous()}")
        if x.device != state.device:
            raise ValueError(f"{what} is on {x.device}, state on {state.device}")
    k, b = actions.shape
    sp = body.state_size + (1 if max_steps is not None else 0)
    o = body.obs_size
    for what, x, shape in (("state", state, (sp, b)), ("keys", keys, (b, 2))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{what} has shape {tuple(x.shape)}, body "
                             f"{kernel_id} wants {shape}")
    if k < 1 or b < 1:
        raise ValueError(f"megastep_cuda needs K >= 1 and B >= 1, got {k}, {b}")
    if keys.data_ptr() % 16:
        raise ValueError("megastep_cuda reads each lane's key as 16 bytes: "
                         "keys must be 16-byte aligned")

    new_state = torch.empty_like(state)
    final_keys = torch.empty_like(keys)
    obs = torch.empty((k, o, b), dtype=torch.float32, device=state.device)
    tobs = torch.empty_like(obs)
    reward, done, trunc = (torch.empty_like(actions) for _ in range(3))
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    rc = _library()(
        kernel_id, -1 if max_steps is None else int(max_steps), b, k,
        ptr(state), ptr(keys), ptr(actions), ptr(new_state), ptr(final_keys),
        ptr(obs), ptr(tobs), ptr(reward), ptr(done), ptr(trunc),
        ctypes.c_void_p(torch.cuda.current_stream(state.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"megastep kernel launch failed: cudaError {rc}")
    megastep_cuda.launches += 1
    return new_state, final_keys, obs, tobs, reward, done, trunc


#: kernel launches since the count was last set to 0 (chip_smoke.py reads it)
megastep_cuda.launches = 0

__all__ = ["BODIES", "Body", "megastep_cuda"]
