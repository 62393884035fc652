"""CUDA megastep: K fused environment steps per kernel launch.

The port of the Pallas TPU kernel
`src/repro/kernels/envstep/megastep.py::megastep_pallas`. The kernel itself
is hand-written CUDA C++ for sm_90a in `csrc/megastep.cu` (design and bound
in its header); this module is its wrapper: it checks the operands,
allocates the outputs, launches on PyTorch's current stream and counts the
launches. It takes only CUDA tensors and raises on anything else; the plain
version for the CPU is `ref.megastep_ref`, chosen by `ops.env_megastep`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch


class Body(NamedTuple):
    kernel_id: int      # the `body` switch in csrc/megastep.cu
    state_size: int     # S
    obs_size: int       # O


#: the kernel's env bodies, by env class name; must match csrc/megastep.cu
BODIES = {
    "CartPole": Body(0, 4, 4),
    "MountainCar": Body(1, 2, 2),
    "Pendulum": Body(2, 2, 3),
    "Acrobot": Body(3, 4, 6),
    "Pong": Body(4, 6, 6),
    "Breakout": Body(5, 29, 29),
    "LightsOut": Body(6, 26, 25),
    "FrozenLake": Body(7, 17, 16),
    "CliffWalk": Body(8, 49, 48),
    "Maze": Body(9, 66, 64),
    "Snake": Body(10, 76, 36),
}
_BY_ID = {b.kernel_id: b for b in BODIES.values()}


def _library():
    from repro_torch.kernels.build import load

    lib = load("megastep")
    fn = lib.megastep
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 11
        fn.restype = ctypes.c_int
    return fn


def megastep_cuda(kernel_id: int, state: torch.Tensor, actions: torch.Tensor,
                  fresh: torch.Tensor, fresh_obs: torch.Tensor, *,
                  max_steps: Optional[int] = None):
    """Run K fused env steps over the batch as one CUDA launch.

    state (S', B), actions (K, B), fresh (K, S', B) precomputed auto-reset
    states, fresh_obs (K, O, B); contiguous float32 on one CUDA device, with
    S' = S + 1 (the step counter row) when `max_steps` is given. Returns
    (new_state (S', B), obs (K, O, B), terminal_obs (K, O, B), reward (K, B),
    done (K, B), truncated (K, B)), float32.
    """
    if kernel_id not in _BY_ID:
        raise ValueError(f"no megastep kernel body {kernel_id}")
    body = _BY_ID[kernel_id]
    operands = {"state": state, "actions": actions, "fresh": fresh,
                "fresh_obs": fresh_obs}
    for what, x in operands.items():
        if not x.is_cuda:
            raise ValueError(f"megastep_cuda takes CUDA tensors; {what} is on "
                             f"{x.device}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"megastep_cuda takes contiguous float32; {what} "
                             f"is {x.dtype}, contiguous={x.is_contiguous()}")
        if x.device != state.device:
            raise ValueError(f"{what} is on {x.device}, state on {state.device}")
    k, b = actions.shape
    sp = body.state_size + (1 if max_steps is not None else 0)
    o = body.obs_size
    want = {"state": (sp, b), "fresh": (k, sp, b), "fresh_obs": (k, o, b)}
    for what, shape in want.items():
        if tuple(operands[what].shape) != shape:
            raise ValueError(f"{what} has shape {tuple(operands[what].shape)}, "
                             f"body {kernel_id} wants {shape}")
    if k < 1 or b < 1:
        raise ValueError(f"megastep_cuda needs K >= 1 and B >= 1, got {k}, {b}")

    new_state = torch.empty_like(state)
    obs = torch.empty((k, o, b), dtype=torch.float32, device=state.device)
    tobs = torch.empty_like(obs)
    reward, done, trunc = (torch.empty_like(actions) for _ in range(3))
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    rc = _library()(
        kernel_id, -1 if max_steps is None else int(max_steps), b, k,
        ptr(state), ptr(actions), ptr(fresh), ptr(fresh_obs),
        ptr(new_state), ptr(obs), ptr(tobs), ptr(reward), ptr(done),
        ptr(trunc),
        ctypes.c_void_p(torch.cuda.current_stream(state.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"megastep kernel launch failed: cudaError {rc}")
    megastep_cuda.launches += 1
    return new_state, obs, tobs, reward, done, trunc


#: kernel launches since the count was last set to 0 (chip_smoke.py reads it)
megastep_cuda.launches = 0

__all__ = ["BODIES", "Body", "megastep_cuda"]
