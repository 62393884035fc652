"""Batched environment execution engines (port of `repro.pool`).

  - `make_vec`  : the frontend. One constructor, one shared protocol;
                  returns the right pool for the request.
  - `EnvPool`   : the device-resident batched pool, Gym-style reset/step
                  plus a pure `xla()` API over an explicit carry.
  - `HostPool`  : the same API over interpreted host envs (the paper's
                  foreign-runtime stand-ins), threaded + double-buffered.
  - `make_pool` : the registry-id factory of the JAX package's first API
                  (kept for its callers; new code calls `make_vec`).

The sharded and async pools come with ROADMAP A12 and A11: their requests
raise naming the item.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.env import Env, supports_fused_step
from repro_torch.core.registry import make as registry_make
from repro_torch.core.spaces import sample_batch
from repro_torch.kernels.envstep.ops import kernel_mismatch
from repro_torch.pool.envpool import (EnvPool, FUSED_BACKENDS, PoolState,
                                      PoolStep, XlaPool, resolve_device)
from repro_torch.pool.host import HostPool

#: step-engine names `make_vec` accepts besides "auto"
STEP_BACKENDS = ("vmap",) + FUSED_BACKENDS


def make_vec(env: Union[str, Env], num_envs: int, *, backend: str = "auto",
             unroll: int = 1, device=None, mesh=None, host: bool = False,
             num_workers: Optional[int] = None, **env_kwargs):
    """`make_vec(id, num_envs)` -> the right pool.

      - default     -> `EnvPool` on `device` (the CUDA card when None;
                       raises if CUDA is absent)
      - `host=True` -> `HostPool` of interpreted baselines on
                       `num_workers` threads

    `backend="auto"` picks with `auto_backend`; "vmap", "cuda" or "torch"
    pin one. `unroll` is the number of steps per megastep launch in
    `rollout` and `step_many`. `env_kwargs` go to the registry
    (`core.registry.make`), so construction errors name the id and the
    offending kwargs; an instance built so that the CUDA kernel's compiled
    body does not fit it steps on "vmap" under `auto` on the card and
    raises under "cuda".
    """
    if backend == "async":
        raise NotImplementedError("backend='async' comes with the async pool "
                                  "(ROADMAP A11)")
    if host:
        if not isinstance(env, str):
            raise ValueError("host=True builds interpreted baselines and "
                             "needs a registry id, not an Env instance")
        if mesh is not None:
            raise ValueError("host=True and mesh=... are mutually exclusive")
        if env_kwargs:
            raise ValueError(
                f"env_kwargs {sorted(env_kwargs)} cannot be applied with "
                "host=True: interpreted baselines (envs.baseline_python) are "
                "fixed default-config ports, and silently dropping the kwargs "
                "would compare differently-configured envs")
        return HostPool(env, num_envs, num_workers=num_workers)
    if mesh is not None:
        raise NotImplementedError("mesh= pools come with the runtime slice "
                                  "(ROADMAP A12)")
    device = resolve_device(device)
    if isinstance(env, str):
        env = registry_make(env, **env_kwargs)
    elif env_kwargs:
        raise ValueError(f"env_kwargs {sorted(env_kwargs)} only apply when "
                         "building from a registry id, not an Env instance")
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
    PyTorch version ("torch") on other devices; otherwise "vmap" (also for
    a stack holding a transform with no fusion role, `FlattenObs` or
    `RewardScale`)."""
    if not supports_fused_step(env):
        return "vmap"
    if device.type != "cuda":
        return "torch"
    return "cuda" if kernel_mismatch(env) is None else "vmap"


def make_pool(name: str, num_envs: int, backend: str = "xla", mesh=None,
              step_backend: str = "vmap", unroll: int = 1, device=None,
              **env_kwargs):
    """The JAX package's first pool factory, over `make_vec`.

    backend: "xla"/"vmap" (EnvPool on `step_backend`) | "cuda"/"torch"
    (EnvPool on the megastep) | "host" (HostPool). "async" and "sharded"
    raise naming ROADMAP A11 and A12.
    """
    if backend in ("xla", "vmap"):
        return make_vec(name, num_envs, backend=step_backend, unroll=unroll,
                        device=device, **env_kwargs)
    if backend == "async":
        return make_vec(name, num_envs, backend="async", **env_kwargs)
    if backend in FUSED_BACKENDS:
        return make_vec(name, num_envs, backend=backend, unroll=unroll,
                        device=device, **env_kwargs)
    if backend == "sharded":
        raise NotImplementedError("backend='sharded' comes with the runtime "
                                  "slice (ROADMAP A12)")
    if backend == "host":
        return make_vec(name, num_envs, host=True)
    raise ValueError(f"unknown pool backend {backend!r}; expected 'xla', "
                     f"'sharded', 'host' or one of {FUSED_BACKENDS}")


#: the JAX package's `repro.pool` surface less the async and sharded pools
#: (ROADMAP A11, A12); `auto_backend` stays importable from here
__all__ = ["EnvPool", "FUSED_BACKENDS", "HostPool", "PoolState", "PoolStep",
           "STEP_BACKENDS", "XlaPool", "make_pool", "make_vec",
           "sample_batch"]
