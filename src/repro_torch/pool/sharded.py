"""ShardedEnvPool: the env batch split over a tuple of devices (port of
`repro.pool.sharded`).

The JAX pool lays the batch axis over a device mesh's data axes with
`shard_map`; here the mesh is a tuple of `torch.device`s, and each shard
steps its `num_envs / n_shards` lanes on its own device, one megastep
launch per shard per chunk on the fused backends. Env steps are
embarrassingly parallel, so no shard reads another's lanes. The API is
EnvPool's (stateful `reset`/`step`, `xla()`, `rollout`); outputs are
gathered onto the mesh's first device.

RNG, as in the JAX pool: every shard folds the step key with its shard
index, so streams differ across shards; on a 1-device mesh the fold is
skipped, which makes ShardedEnvPool bit for bit EnvPool. A tuple that
repeats one card (`("cuda:0", "cuda:0")`) is a 2-shard pool on it, which is
how a 2-to-1-shard re-mesh runs on one H100.

Snapshots are gathered: `state_dict()` is EnvPool's structure over the
whole batch, and `load_state_dict` splits one over this pool's shards, so
a snapshot taken on a bigger mesh restores here unchanged (the elastic
restore path of runtime/supervisor.py).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch import random as R
from repro_torch.core.env import Env
from repro_torch.core.registry import make as registry_make
from repro_torch.core.wrappers import AutoReset, Vec
from repro_torch.device import resolve_device
from repro_torch.pool.envpool import (EnvPool, PoolState, PoolStep,
                                      _load_like, _to_numpy)


def default_pool_mesh(num_devices: Optional[int] = None
                      ) -> Tuple[torch.device, ...]:
    """The first `num_devices` visible CUDA devices (all of them by
    default). Raises when CUDA is absent."""
    resolve_device(None)
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    if num_devices is not None:
        devices = devices[:num_devices]
    return tuple(devices)


def _cat(parts, dim, device):
    return torch.cat([p.to(device) for p in parts], dim)


class ShardedEnvPool(EnvPool):
    """EnvPool with the batch split over a tuple of devices."""

    def __init__(self, env: Union[Env, str], num_envs: int,
                 mesh: Optional[Sequence] = None, backend: str = "vmap",
                 unroll: int = 1, **env_kwargs):
        self.mesh = tuple(torch.device(d) for d in (
            mesh if mesh is not None else default_pool_mesh()))
        device = self.mesh_device(self.mesh)
        self.n_shards = len(self.mesh)
        if num_envs % self.n_shards:
            raise ValueError(
                f"num_envs={num_envs} must divide evenly over the "
                f"{self.n_shards} devices of the mesh")
        if isinstance(env, str):
            env = registry_make(env, **env_kwargs)
        elif env_kwargs:
            raise ValueError(f"env_kwargs {sorted(env_kwargs)} only apply "
                             "when building from a registry id")
        super().__init__(env, num_envs, backend=backend, unroll=unroll,
                         device=device)
        self.shard_size = self.num_envs // self.n_shards
        self._local = Vec(AutoReset(self.env), self.shard_size)

    @staticmethod
    def mesh_device(mesh) -> torch.device:
        """The mesh's first device, where outputs gather, after checking
        that the mesh is not empty, that its devices are of one type, and
        (`resolve_device`) that CUDA is present if they are CUDA devices."""
        devices = [resolve_device(d) for d in mesh]
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a mesh's devices are of one type; got "
                             f"{[str(d) for d in devices]}")
        return devices[0]

    def __repr__(self) -> str:  # pragma: no cover
        return (f"ShardedEnvPool({self.env.name}, num_envs={self.num_envs}, "
                f"backend={self.backend!r}, mesh={[str(d) for d in self.mesh]})")

    def _lanes(self, i: int) -> slice:
        return slice(i * self.shard_size, (i + 1) * self.shard_size)

    def _shard_key(self, key: torch.Tensor, i: int) -> torch.Tensor:
        """Shard i's RNG stream; the key itself on a 1-device mesh."""
        key = key.to(self.mesh[i])
        return key if self.n_shards == 1 else R.fold_in(key, i)

    def _gather(self, outs, dim):
        """Per-shard (obs, reward, done, info) -> one, on the first device."""
        cat = lambda xs: _cat(xs, dim, self.device)
        return (cat([o[0] for o in outs]), cat([o[1] for o in outs]),
                cat([o[2] for o in outs]),
                {k: cat([o[3][k] for o in outs]) for k in outs[0][3]})

    # -- pure API, per shard ------------------------------------------------
    def _xla_init(self, key: torch.Tensor) -> PoolState:
        states, obs = [], []
        for i in range(self.n_shards):
            s, o = self._local.reset(self._shard_key(key, i))
            states.append(s)
            obs.append(o)
        return PoolState(states, _cat(obs, 0, self.device),
                         R.fold_in(key, 0x57EB))

    def _step_many_core(self, env_state, actions, key, venv=None):
        """The K-step block per shard: on the fused backends one megastep
        launch per shard per chunk, on vmap the shard's steps."""
        states, outs = [], []
        for i, dev in enumerate(self.mesh):
            s, out = EnvPool._step_many_core(
                self, env_state[i], actions[:, self._lanes(i)].to(dev),
                self._shard_key(key, i), venv=self._local)
            states.append(s)
            outs.append(out)
        return states, self._gather(outs, 1)

    def _xla_step(self, carry: PoolState, actions: torch.Tensor,
                  key: Optional[torch.Tensor] = None):
        if self._fused:  # through the per-shard megastep block
            return EnvPool._xla_step(self, carry, actions, key)
        next_key, key = self._next_keys(carry, key)
        states, outs = [], []
        for i, dev in enumerate(self.mesh):
            ts = self._local.step(carry.env_state[i],
                                  actions[self._lanes(i)].to(dev),
                                  self._shard_key(key, i))
            states.append(ts.state)
            outs.append((ts.obs, ts.reward, ts.done, ts.info))
        obs, reward, done, info = self._gather(outs, 0)
        return (PoolState(states, obs, next_key),
                PoolStep(obs, reward, done, info))

    def _render(self, env_state) -> torch.Tensor:
        return _cat([self._local.render(s) for s in env_state], 0,
                    self.device)

    # -- snapshot / restore -------------------------------------------------
    def state_dict(self):
        """The gathered snapshot: EnvPool's structure over the whole batch."""
        if self._carry is None:
            raise RuntimeError("call reset() before snapshotting the pool")
        shards, key = self._carry
        parts = [tree_map(_to_numpy, s) for s in shards]
        env_state = tree_map(lambda *xs: np.concatenate(xs, 0), *parts)
        return {"env_state": env_state, "key": _to_numpy(key),
                "obs": _to_numpy(self._obs)}

    def load_state_dict(self, d) -> None:
        """Split a gathered snapshot (this pool's, EnvPool's, or the JAX
        pool's, from any mesh) over this pool's shards."""
        template = self._xla_init(R.PRNGKey(0, self.device))
        shards = []
        for i, dev in enumerate(self.mesh):
            part = tree_map(lambda x: np.asarray(x)[self._lanes(i)],
                            d["env_state"])
            shards.append(_load_like(template.env_state[i], part, dev))
        self._carry = (shards, _load_like(template.key, d["key"], self.device))
        self._obs = _load_like(template.obs, d["obs"], self.device)


__all__ = ["ShardedEnvPool", "default_pool_mesh"]
