"""Batched environment execution engines (port of `repro.pool`).

`make_vec` is the frontend; `EnvPool` the single-device pool. The sharded,
async and host pools come with later slices (ROADMAP A11, A12).
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.core.env import Env, supports_fused_step
from repro_torch.core.registry import make as registry_make
from repro_torch.core.spaces import sample_batch
from repro_torch.kernels.envstep.ops import kernel_mismatch
from repro_torch.pool.envpool import (EnvPool, FUSED_BACKENDS, PoolState,
                                      PoolStep, XlaPool, resolve_device)

#: step-engine names `make_vec` accepts besides "auto"
STEP_BACKENDS = ("vmap",) + FUSED_BACKENDS


def make_vec(env: Union[str, Env], num_envs: int, *, backend: str = "auto",
             unroll: int = 1, device=None, mesh=None, host: bool = False):
    """`make_vec(id, num_envs)` -> an `EnvPool` on `device` (the CUDA card
    when None; raises if CUDA is absent).

    `backend="auto"` picks with `auto_backend`. `unroll` is the number of
    steps per megastep launch in `rollout` and `step_many`.
    """
    if backend == "async":
        raise NotImplementedError("backend='async' comes with the async pool "
                                  "(ROADMAP A11)")
    if mesh is not None or host:
        raise NotImplementedError("mesh= and host= pools come with the "
                                  "runtime slice (ROADMAP A12)")
    device = resolve_device(device)
    if isinstance(env, str):
        env = registry_make(env)
    if backend == "auto":
        backend = auto_backend(env, device)
    elif backend not in STEP_BACKENDS:
        raise ValueError(f"unknown step backend {backend!r}; expected 'auto' "
                         f"or one of {STEP_BACKENDS}")
    return EnvPool(env, num_envs, backend=backend, unroll=unroll, device=device)


def auto_backend(env: Env, device: torch.device) -> str:
    """The step backend `make_vec(backend="auto")` takes on `device`: the
    fused megastep when the stack has one, as the CUDA kernel ("cuda") on a
    CUDA device where its compiled body fits the instance, as its plain
    PyTorch version ("torch") on other devices; otherwise "vmap"."""
    if not supports_fused_step(env):
        return "vmap"
    if device.type != "cuda":
        return "torch"
    return "cuda" if kernel_mismatch(env) is None else "vmap"


__all__ = ["EnvPool", "FUSED_BACKENDS", "PoolState", "PoolStep",
           "STEP_BACKENDS", "XlaPool", "auto_backend", "make_vec",
           "sample_batch"]
