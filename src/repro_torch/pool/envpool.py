"""EnvPool-style batched environment engine (port of `repro.pool.envpool`).

The batched env state lives on the pool's device and never crosses to the
host on the step path. Two surfaces, as in the JAX package:

  - Gym-style stateful:  `obs = pool.reset(seed)`,
                         `obs, rew, done, info = pool.step(actions)`.
  - pure functions:      `h = pool.xla()`, `carry = h.init(key)`,
                         `carry, out = h.step(carry, actions[, key])`.
    The name is kept so the JAX counterpart is easy to find; here they are
    plain PyTorch functions of an explicit carry.

Backends: "vmap" steps `Vec(AutoReset(env))` once per step with plain
tensor ops; "cuda" runs `unroll` steps per launch of the CUDA megastep
kernel; "torch" runs the megastep's plain PyTorch version (the CPU path).
Pixel ids (`Pong-v0`, `Breakout-v0`, the grid suite's `-px`) observe
(B, 4, 84, 84) frame stacks on every backend; the fused ones render each
chunk's frames in two launches of the raster kernel ("cuda") or its plain
version ("torch"). The RNG plumbing (pool key, per-step keys, action
sampling) is the JAX pool's, so every backend follows the JAX pool's
trajectories, Multitask's too, whose dynamics read the per-step key.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.core.env import Env, supports_fused_step
from repro_torch.core.registry import make as registry_make
from repro_torch.core.spaces import sample_batch
from repro_torch.core.wrappers import AutoReset, Vec
from repro_torch.device import resolve_device
from repro_torch.kernels.envstep.ops import kernel_mismatch

#: megastep backends: the CUDA kernel, or its plain PyTorch version
FUSED_BACKENDS = ("cuda", "torch")


class PoolState(NamedTuple):
    """Pool carry. Everything stays on the pool's device."""

    env_state: Any          # Vec(AutoReset(env)) state, leading dim B
    obs: torch.Tensor       # (B, ...) current observation
    key: torch.Tensor       # fallback RNG stream for key-less stepping


class PoolStep(NamedTuple):
    """One batched transition (post-autoreset obs; terminal obs in info)."""

    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    info: Dict[str, torch.Tensor]


class XlaPool(NamedTuple):
    """Pure-function handle (counterpart of the JAX pool's XLA API)."""

    init: Callable[[torch.Tensor], PoolState]
    step: Callable[..., Tuple[PoolState, PoolStep]]
    step_many: Callable[..., Tuple[PoolState, PoolStep]]


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


def check_backend(env: Env, backend: str, device: torch.device) -> None:
    """Raise unless `env` can step on `backend` on `device`: the fused
    backends need a megastep spec (ValueError), "cuda" a compiled body that
    fits the instance (NotImplementedError) and a CUDA device (ValueError)."""
    if backend in FUSED_BACKENDS:
        if not supports_fused_step(env):
            raise ValueError(f"backend={backend!r} needs a fused megastep "
                             f"spec, and {env.name} has none; use "
                             "backend='vmap'")
        why = kernel_mismatch(env) if backend == "cuda" else None
        if why is not None:
            raise NotImplementedError(why)
        if backend == "cuda" and device.type != "cuda":
            raise ValueError("backend='cuda' runs the CUDA kernel and "
                             f"needs a CUDA device, not {device}")
    elif backend != "vmap":
        raise ValueError(f"unknown pool backend {backend!r}; expected "
                         f"'vmap' or one of {FUSED_BACKENDS}")


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    a = x.detach().cpu().numpy().copy()
    return a.astype(np.uint32) if x.dtype == R.KEY_DTYPE else a


def _load_like(template, src, device):
    """Rebuild `template`'s structure from `src`: NamedTuples read by field
    names only, dicts by key, lists by position."""
    if isinstance(template, tuple):
        return type(template)(**{f: _load_like(getattr(template, f),
                                               getattr(src, f), device)
                                 for f in template._fields})
    if isinstance(template, dict):
        return {k: _load_like(v, src[k], device) for k, v in template.items()}
    if isinstance(template, list):
        return [_load_like(v, s, device) for v, s in zip(template, src,
                                                          strict=True)]
    arr = np.array(src)
    if arr.shape != tuple(template.shape):
        raise ValueError(f"snapshot leaf has shape {arr.shape}, this pool "
                         f"holds {tuple(template.shape)}")
    if template.dtype == R.KEY_DTYPE:
        arr = arr.astype(np.int64)
    return torch.as_tensor(arr, device=device).to(template.dtype)


def _map(fn, tree):
    if isinstance(tree, tuple):
        return type(tree)(*(_map(fn, x) for x in tree))
    return fn(tree)


class EnvPool:
    """Batched pool of one env type: `Vec(AutoReset(env), num_envs)`.

    >>> pool = EnvPool("CartPole-v1", num_envs=256, backend="cuda")
    >>> obs = pool.reset(seed=0)                  # (256, 4) on the card
    >>> obs, rew, done, info = pool.step(actions)
    """

    def __init__(self, env: Union[Env, str], num_envs: int,
                 backend: str = "vmap", unroll: int = 1, device=None):
        if isinstance(env, str):
            env = registry_make(env)
        self.env = env
        self.num_envs = int(num_envs)
        self.device = resolve_device(device)
        self.backend = backend
        self.unroll = max(int(unroll), 1)
        check_backend(env, backend, self.device)
        self.venv = Vec(AutoReset(env), self.num_envs)
        self._carry: Optional[Tuple[Any, torch.Tensor]] = None  # (state, key)
        self._obs: Optional[torch.Tensor] = None

    @property
    def observation_space(self):
        return self.env.observation_space

    @property
    def action_space(self):
        return self.env.action_space

    def __len__(self) -> int:
        return self.num_envs

    def __repr__(self) -> str:  # pragma: no cover
        return (f"{type(self).__name__}({self.env.name}, num_envs="
                f"{self.num_envs}, backend={self.backend!r}, "
                f"device={self.device})")

    @property
    def _fused(self) -> bool:
        return self.backend in FUSED_BACKENDS

    # -- pure API ------------------------------------------------------------
    def _xla_init(self, key: torch.Tensor) -> PoolState:
        state, obs = self.venv.reset(key)
        return PoolState(state, obs, R.fold_in(key, 0x57EB))

    def _step_many_core(self, env_state, actions: torch.Tensor,
                        key: torch.Tensor, venv: Optional[Vec] = None):
        """K batched env steps -> (env_state, (obs, reward, done, info)),
        outputs stacked on a leading (K, ...) axis. On the vmap backend step
        i gets the key `fold_in(key, i)` (split over `venv`'s lanes, this
        pool's by default); the fused backends' dynamics read no per-step
        key, as in the JAX pool."""
        if self._fused:
            new_state, ts = self.env.fused_step(
                env_state, actions, num_steps=actions.shape[0],
                backend=self.backend)
            return new_state, (ts.obs, ts.reward, ts.done, ts.info)
        venv = venv if venv is not None else self.venv
        keys = R.fold_in(key, torch.arange(actions.shape[0],
                                           device=key.device))
        outs = []
        for a, k in zip(actions, keys):
            ts = venv.step(env_state, a, k)
            env_state = ts.state
            outs.append(ts)
        info = {k: torch.stack([ts.info[k] for ts in outs]) for k in outs[0].info}
        return env_state, (torch.stack([ts.obs for ts in outs]),
                           torch.stack([ts.reward for ts in outs]),
                           torch.stack([ts.done for ts in outs]), info)

    def _next_keys(self, carry: PoolState, key):
        """(next carry key, step key): without `key` the carry's chain
        advances and its split gives the step key, as in the JAX pool."""
        if key is None:
            pair = R.split(carry.key)
            return pair[0], pair[1]
        return carry.key, key

    def _xla_step(self, carry: PoolState, actions: torch.Tensor,
                  key: Optional[torch.Tensor] = None
                  ) -> Tuple[PoolState, PoolStep]:
        """One step. The vmap backend hands `key` itself to `Vec.step`,
        which splits it into lane keys, as the JAX pool's single step does;
        the fused backends run a one-step chunk."""
        if self._fused:
            ps, out = self._xla_step_many(carry, actions[None], key)
            return ps, PoolStep(out.obs[0], out.reward[0], out.done[0],
                                {k: v[0] for k, v in out.info.items()})
        next_key, key = self._next_keys(carry, key)
        ts = self.venv.step(carry.env_state, actions, key)
        return (PoolState(ts.state, ts.obs, next_key),
                PoolStep(ts.obs, ts.reward, ts.done, ts.info))

    def _xla_step_many(self, carry: PoolState, actions: torch.Tensor,
                       key: Optional[torch.Tensor] = None
                       ) -> Tuple[PoolState, PoolStep]:
        """Step the pool `actions.shape[0]` times; outputs carry a leading
        (K, ...) axis. On the vmap backend step i gets `fold_in(key, i)`
        (`_step_many_core`), where `_xla_step` hands `key` itself to
        `Vec.step`: the JAX pool keys its two steps so too."""
        next_key, key = self._next_keys(carry, key)
        state, (obs, reward, done, info) = self._step_many_core(
            carry.env_state, actions, key)
        return (PoolState(state, obs[-1], next_key),
                PoolStep(obs, reward, done, info))

    def xla(self) -> XlaPool:
        """Pure `(init, step, step_many)` over an explicit carry."""
        return XlaPool(self._xla_init, self._xla_step, self._xla_step_many)

    # -- Gym-style stateful API ---------------------------------------------
    def reset(self, seed: int = 0) -> torch.Tensor:
        """(Re)initialise all envs; returns the batched observation."""
        ps = self._xla_init(R.PRNGKey(seed, self.device))
        self._carry, self._obs = (ps.env_state, ps.key), ps.obs
        return self._obs

    def step(self, actions, key: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict]:
        """Step every env once. Autoreset on done. `key` pins the per-step
        RNG stream and leaves the carry's chain untouched."""
        if self._carry is None:
            raise RuntimeError("call reset() before step()")
        env_state, carry_key = self._carry
        ps, out = self._xla_step(PoolState(env_state, self._obs, carry_key),
                                 torch.as_tensor(actions, device=self.device),
                                 key)
        self._carry, self._obs = (ps.env_state, ps.key), out.obs
        return out.obs, out.reward, out.done, out.info

    def sample_actions(self, seed: int = 0) -> torch.Tensor:
        return sample_batch(self.action_space, R.PRNGKey(seed, self.device),
                            self.num_envs)

    # -- snapshot / restore -------------------------------------------------
    @property
    def has_carry(self) -> bool:
        """Whether `state_dict()` has a carry to snapshot (after `reset` or
        `load_state_dict`)."""
        return self._carry is not None

    def state_dict(self) -> Dict[str, Any]:
        """Host snapshot of the stateful carry, in the JAX pool's structure:
        numpy leaves, float32 state, int32 step counters, uint32 keys."""
        if self._carry is None:
            raise RuntimeError("call reset() before snapshotting the pool")
        env_state, key = self._carry
        return {"env_state": _map(_to_numpy, env_state), "key": _to_numpy(key),
                "obs": _to_numpy(self._obs)}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        """Restore a `state_dict()` snapshot, this pool's or the JAX pool's:
        its NamedTuples are read by field name, its leaves as arrays."""
        template = self._xla_init(R.PRNGKey(0, self.device))
        self._carry = (_load_like(template.env_state, d["env_state"],
                                  self.device),
                       _load_like(template.key, d["key"], self.device))
        self._obs = _load_like(template.obs, d["obs"], self.device)

    def _render(self, env_state) -> torch.Tensor:
        return self.venv.render(env_state)

    # -- whole-rollout fast path --------------------------------------------
    def rollout(self, num_steps: int, key: torch.Tensor, render: bool = False):
        """Random-policy rollout: (sum_reward (B,), episodes (B,), last).

        Fused backends run `unroll` steps per megastep launch. The RNG is
        the JAX pool's: the carry from `fold_in(key, 0x5EED)`, step i's
        actions (and, on the vmap backend, its step key) from
        `fold_in(key, i)`, i in 1..num_steps. `last` is zeros
        (B,), or with `render=True` the frame (B, H, W) rendered from the
        state after the last step: render mode renders after every step
        (paper Fig. 1's render column), so it keeps the per-step body, one
        fused step per launch on fused backends.
        """
        key = key.to(self.device)
        ps = self._xla_init(R.fold_in(key, 0x5EED))
        rew = torch.zeros(self.num_envs, dtype=torch.float32, device=self.device)
        eps = torch.zeros(self.num_envs, dtype=torch.int32, device=self.device)
        last = torch.zeros_like(rew)
        if render or not self._fused:
            if render:
                last = self._render(ps.env_state)
            for i in range(1, num_steps + 1):
                k = R.fold_in(key, i)
                acts = sample_batch(self.action_space, k, self.num_envs)
                ps, out = self._xla_step(ps, acts, k)
                rew = rew + out.reward
                eps = eps + out.done.to(torch.int32)
                if render:
                    last = self._render(ps.env_state)
            return rew, eps, last
        kk = max(min(self.unroll, num_steps), 1)
        for start in range(1, num_steps + 1, kk):
            n = min(kk, num_steps + 1 - start)
            steps = torch.arange(start, start + n, dtype=R.KEY_DTYPE,
                                 device=self.device)
            acts = sample_batch(self.action_space, R.fold_in(key, steps),
                                self.num_envs)
            ps, out = self._xla_step_many(ps, acts, key)
            rew = rew + out.reward.sum(0)
            eps = eps + out.done.sum(0, dtype=torch.int32)
        return rew, eps, last


__all__ = ["EnvPool", "FUSED_BACKENDS", "PoolState", "PoolStep", "XlaPool",
           "auto_backend", "check_backend", "resolve_device"]
