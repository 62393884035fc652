"""Batched environment execution engines (port of `repro.pool`).

  - `make_vec`  : the frontend. One constructor, one shared protocol;
                  returns the right pool for the request.
  - `EnvPool`   : the device-resident batched pool, Gym-style reset/step
                  plus a pure `xla()` API over an explicit carry.
  - `ShardedEnvPool` : the same API, the batch split over a tuple of
                  devices (one megastep launch per shard per chunk).
  - `AsyncEnvPool` : async mode: `send(actions, ids)` / `recv()` step only
                  the ready lanes; sessions are written into free slots.
  - `HostPool`  : the same API over interpreted host envs (the paper's
                  foreign-runtime stand-ins), threaded + double-buffered.
  - `make_pool` : the registry-id factory of the JAX package's first API
                  (kept for its callers; new code calls `make_vec`).
"""
from __future__ import annotations

from typing import Optional, Union

from repro_torch.core.env import Env
from repro_torch.core.registry import make as registry_make
from repro_torch.core.spaces import sample_batch
from repro_torch.pool.async_pool import AsyncEnvPool, AsyncUnsupportedError
from repro_torch.pool.envpool import (EnvPool, FUSED_BACKENDS, PoolState,
                                      PoolStep, XlaPool, auto_backend,
                                      resolve_device)
from repro_torch.pool.host import HostPool
from repro_torch.pool.sharded import ShardedEnvPool, default_pool_mesh

#: step-engine names `make_vec` accepts besides "auto"
STEP_BACKENDS = ("vmap",) + FUSED_BACKENDS


def make_vec(env: Union[str, Env], num_envs: int, *, backend: str = "auto",
             unroll: int = 1, device=None, mesh=None, host: bool = False,
             num_workers: Optional[int] = None, **env_kwargs):
    """`make_vec(id, num_envs)` -> the right pool.

      - default           -> `EnvPool` on `device` (the CUDA card when
                             None; raises if CUDA is absent)
      - `backend="async"` -> `AsyncEnvPool` on `device` (send/recv,
                             continuous refill; `num_envs` is the slot count)
      - `mesh=...`        -> `ShardedEnvPool` over that tuple of devices
      - `host=True`       -> `HostPool` of interpreted baselines on
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
        if mesh is not None or host:
            raise ValueError("backend='async' is single-process and "
                             "device-resident; mesh=/host= do not apply")
        return AsyncEnvPool(env, num_envs, device=device, **env_kwargs)
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
        if device is not None:
            raise ValueError("mesh= names the pool's devices; device= does "
                             "not apply")
        device = ShardedEnvPool.mesh_device(mesh)
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
    if mesh is not None:
        return ShardedEnvPool(env, num_envs, mesh=mesh, backend=backend,
                              unroll=unroll)
    return EnvPool(env, num_envs, backend=backend, unroll=unroll, device=device)


def make_pool(name: str, num_envs: int, backend: str = "xla", mesh=None,
              step_backend: str = "vmap", unroll: int = 1, device=None,
              **env_kwargs):
    """The JAX package's first pool factory, over `make_vec`.

    backend: "xla"/"vmap" (EnvPool on `step_backend`) | "cuda"/"torch"
    (EnvPool on the megastep) | "async" (AsyncEnvPool) | "sharded"
    (ShardedEnvPool over `mesh`, else over `device`, else over
    `default_pool_mesh()`; combine with `step_backend=`) | "host"
    (HostPool).
    """
    if backend in ("xla", "vmap"):
        return make_vec(name, num_envs, backend=step_backend, unroll=unroll,
                        device=device, **env_kwargs)
    if backend == "async":
        return make_vec(name, num_envs, backend="async", device=device,
                        **env_kwargs)
    if backend in FUSED_BACKENDS:
        return make_vec(name, num_envs, backend=backend, unroll=unroll,
                        device=device, **env_kwargs)
    if backend == "sharded":
        if mesh is None:
            mesh = default_pool_mesh() if device is None else (device,)
        return make_vec(name, num_envs, mesh=mesh, backend=step_backend,
                        unroll=unroll, **env_kwargs)
    if backend == "host":
        return make_vec(name, num_envs, host=True)
    raise ValueError(f"unknown pool backend {backend!r}; expected 'xla', "
                     f"'sharded', 'host' or one of {FUSED_BACKENDS}")


#: the JAX package's `repro.pool` surface; `auto_backend` stays importable
#: from here
__all__ = ["AsyncEnvPool", "AsyncUnsupportedError", "EnvPool",
           "FUSED_BACKENDS", "HostPool", "PoolState", "PoolStep",
           "STEP_BACKENDS", "ShardedEnvPool", "XlaPool", "default_pool_mesh",
           "make_pool", "make_vec", "sample_batch"]
