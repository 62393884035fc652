"""Stateful Gym-API shim (port of `repro.core.gym_compat`): the paper's
drop-in claim (Listing 2).

Wraps the functional core in an object with classic Gym semantics, so a
codebase migrates by swapping `gym.make` for `cairl.make`
(`repro_torch.cairl.make`). The env runs on the shim's device (the CUDA
card unless the caller names one) as one lane: its state has no lane axes,
and `reset`/`step` take one key. Each call returns host values, as Gym
does, so each waits for the device; the compiled fast paths are the
runners (core/runner.py) and the pools.

The key chain is the JAX shim's: `split` on every reset and every step, so
the shim follows the JAX shim's episodes from the same seed.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.core.env import Env
from repro_torch.device import resolve_device


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class _SpaceShim:
    """Gym-style stateful `space.sample()`: each draw takes a seed from the
    shim's numpy generator and samples the space from `PRNGKey(seed)`."""

    def __init__(self, space, rng: np.random.Generator, device):
        self._space = space
        self._rng = rng
        self._device = device

    def __getattr__(self, item):
        # copy and pickle probe dunders (__deepcopy__, __reduce_ex__, ...)
        # before __init__ has filled __dict__; reading self._space here
        # would re-enter __getattr__ forever. Refuse underscore lookups and
        # fetch _space without attribute fallback.
        if item.startswith("_"):
            raise AttributeError(item)
        try:
            space = object.__getattribute__(self, "_space")
        except AttributeError:
            raise AttributeError(item) from None
        return getattr(space, item)

    def sample(self):
        seed = int(self._rng.integers(0, 2**31 - 1))
        return _host(self._space.sample(R.PRNGKey(seed, self._device)))


class GymCompat:
    """`e = cairl.make("CartPole-v1"); e.reset(); e.step(a); e.render()`.

    `new_step_api=True` switches `step` to Gym >= 0.26's 5-tuple `(obs,
    reward, terminated, truncated, info)`, read from the core's
    `info["truncated"]` (core/wrappers.TimeLimit); the default is the
    classic 4-tuple with `done` folded.

    `.spec` is the `EnvSpec` the env was built from (None for a stack
    composed by hand); `render_mode` is stored for call sites written for
    modern Gym, and `render()` always returns the frame, rendered on the
    device by the env's renderer (the raster kernel on the card).
    """

    def __init__(self, env: Env, seed: int = 0, new_step_api: bool = False,
                 render_mode: Optional[str] = None, device=None):
        self._env = env
        self.device = resolve_device(device)
        self._key = R.PRNGKey(seed, self.device)
        self._state: Any = None
        self.new_step_api = bool(new_step_api)
        self.render_mode = render_mode
        self._rng = np.random.default_rng(seed)
        self.observation_space = _SpaceShim(env.observation_space, self._rng,
                                            self.device)
        self.action_space = _SpaceShim(env.action_space, self._rng,
                                       self.device)

    # -- Gym API ---------------------------------------------------------
    def seed(self, seed: int) -> None:
        """Restart the key chain from `seed` and drop the episode in
        flight, which the old chain made: the next call must be reset().
        The spaces keep their generators, as in the JAX shim."""
        self._key = R.PRNGKey(seed, self.device)
        self._rng = np.random.default_rng(seed)
        self._state = None

    def _next_key(self) -> torch.Tensor:
        pair = R.split(self._key)
        self._key = pair[0]
        return pair[1]

    def reset(self) -> np.ndarray:
        self._state, obs = self._env.reset(self._next_key())
        return _host(obs)

    def step(self, action):
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        action = torch.as_tensor(np.asarray(action), device=self.device).to(
            self._env.action_space.dtype)
        ts = self._env.step(self._state, action, self._next_key())
        self._state = ts.state
        obs, reward, done = _host(ts.obs), float(ts.reward), bool(ts.done)
        truncated = bool(ts.info["truncated"]) if "truncated" in ts.info \
            else False
        info = {k: _host(v) for k, v in ts.info.items() if k != "truncated"}
        if self.new_step_api:
            return obs, reward, done and not truncated, truncated, info
        return obs, reward, done, info

    def render(self):
        return _host(self._env.render(self._state))

    def action_space_sample(self):
        return self.action_space.sample()

    @property
    def spec(self):
        """The `EnvSpec` behind this env, or None for a stack composed by
        hand (modern `gym.Env.spec`)."""
        from repro_torch.core.registry import spec_of

        return spec_of(self._env)

    @property
    def unwrapped(self) -> Env:
        return self._env.unwrapped

    def close(self) -> None:
        self._state = None


__all__ = ["GymCompat"]
