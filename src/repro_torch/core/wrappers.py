"""Wrappers (port of `repro.core.wrappers`): `TimeLimit`, `FlattenObs`,
`RewardScale`, `AutoReset`, `Vec`, and the pixel pipeline's `ObsToPixels`
and `FrameStack`.

Batch-native over the leading lane axes: where the JAX package composes
single-env wrappers and `vmap`s the stack, each wrapper here steps all lanes
at once.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.core.env import Env
from repro_torch.core.spaces import Box, Space, flatten_obs, flatten_space


class Wrapper(Env):
    """Delegating base wrapper."""

    def __init__(self, env: Env):
        self.env = env

    @property
    def observation_space(self) -> Space:  # type: ignore[override]
        return self.env.observation_space

    @property
    def action_space(self) -> Space:  # type: ignore[override]
        return self.env.action_space

    @property
    def unwrapped(self) -> Env:
        return self.env.unwrapped

    @property
    def name(self) -> str:
        return self.env.name

    def reset(self, keys):
        return self.env.reset(keys)

    def step(self, state, action, key=None):
        return self.env.step(state, action, key)

    def render(self, state):
        return self.env.render(state)

    def __repr__(self):  # pragma: no cover
        return f"{type(self).__name__}({self.env!r})"


class TimeLimitState(NamedTuple):
    inner: Any
    t: torch.Tensor


class TimeLimit(Wrapper):
    """Truncate episodes at `max_steps`.

    `done` folds terminal | truncation; `info["truncated"]` is True only
    where the cut is the time limit and the state is not env-terminal.
    """

    def __init__(self, env: Env, max_steps: int):
        super().__init__(env)
        self.max_steps = max_steps

    def reset(self, keys):
        inner, obs = self.env.reset(keys)
        t = torch.zeros(keys.shape[:-1], dtype=torch.int32, device=keys.device)
        return TimeLimitState(inner, t), obs

    def step(self, state: TimeLimitState, action, key=None):
        ts = self.env.step(state.inner, action, key)
        t = state.t + 1
        truncated = (t >= self.max_steps) & ~ts.done
        info = dict(ts.info)
        info["truncated"] = truncated
        return ts._replace(state=TimeLimitState(ts.state, t),
                           done=ts.done | truncated, info=info)

    def render(self, state: TimeLimitState):
        return self.env.render(state.inner)


class FlattenObs(Wrapper):
    """Flatten observations to a 1-D Box per lane (the paper's Flatten
    wrapper); discrete observations become one-hot codes."""

    @property
    def observation_space(self) -> Box:  # type: ignore[override]
        return flatten_space(self.env.observation_space)

    def _flat(self, obs):
        return flatten_obs(self.env.observation_space, obs)

    def reset(self, keys):
        state, obs = self.env.reset(keys)
        return state, self._flat(obs)

    def step(self, state, action, key=None):
        ts = self.env.step(state, action, key)
        return ts._replace(obs=self._flat(ts.obs))


class RewardScale(Wrapper):
    """Scale rewards by a static factor."""

    def __init__(self, env: Env, scale: float):
        super().__init__(env)
        self.scale = float(scale)

    def step(self, state, action, key=None):
        ts = self.env.step(state, action, key)
        return ts._replace(reward=ts.reward * self.scale)


class AutoResetState(NamedTuple):
    inner: Any
    key: torch.Tensor


def _where(done: torch.Tensor, a, b):
    """Per-lane select over matching NamedTuple states (or tensors)."""
    if isinstance(a, tuple):
        return type(a)(*(_where(done, x, y) for x, y in zip(a, b)))
    return torch.where(done.reshape(done.shape + (1,) * (a.dim() - done.dim())),
                       a, b)


class AutoReset(Wrapper):
    """Reset lanes whose episode ended, from each lane's own key chain.

    The pre-reset observation is surfaced in `info["terminal_obs"]`; the
    step's key goes to the env's `step` untouched.
    """

    def reset(self, keys):
        pair = R.split(keys)
        inner, obs = self.env.reset(pair[..., 1, :])
        return AutoResetState(inner, pair[..., 0, :]), obs

    def step(self, state: AutoResetState, action, key=None):
        ts = self.env.step(state.inner, action, key)
        pair = R.split(state.key)
        fresh_state, fresh_obs = self.env.reset(pair[..., 1, :])
        info = dict(ts.info)
        info["terminal_obs"] = ts.obs
        return ts._replace(
            state=AutoResetState(_where(ts.done, fresh_state, ts.state),
                                 pair[..., 0, :]),
            obs=_where(ts.done, fresh_obs, ts.obs), info=info)

    def render(self, state: AutoResetState):
        return self.env.render(state.inner)


class Vec(Wrapper):
    """`num_envs` lanes of one env stack.

    `reset(key)` and `step(state, action, key)` split one key into a key per
    lane, as the JAX `Vec` does; the lane keys reach the env's `step`, where
    Multitask draws its new ball and obstacle from them. A `step` without a
    key hands the env none, which only envs free of randomness accept.
    """

    def __init__(self, env: Env, num_envs: int):
        super().__init__(env)
        self.num_envs = num_envs

    def reset(self, key):
        return self.env.reset(R.split(key, self.num_envs))

    def step(self, state, action, key=None):
        keys = None if key is None else R.split(key, self.num_envs)
        return self.env.step(state, action, keys)

    def sample_actions(self, key):
        """One action per lane, each from its own key of
        `split(key, num_envs)`, as the JAX `Vec` samples them."""
        return self.env.action_space.sample(R.split(key, self.num_envs))


class ObsToPixels(Wrapper):
    """Observe the rendered framebuffer (..., H, W) instead of the state:
    the paper's raw-pixels mode (§IV-C), rendered on the env's device."""

    @property
    def observation_space(self) -> Box:  # type: ignore[override]
        h, w = self.env.unwrapped.frame_shape
        return Box(low=0.0, high=1.0, shape=(h, w))

    def reset(self, keys):
        state, _ = self.env.reset(keys)
        return state, self.env.render(state)

    def step(self, state, action, key=None):
        ts = self.env.step(state, action, key)
        return ts._replace(obs=self.env.render(ts.state))


class FrameStackState(NamedTuple):
    inner: Any
    frames: torch.Tensor  # (..., num_frames, H, W), most recent last


class FrameStack(Wrapper):
    """Stack the last `num_frames` observations on a new axis before the
    frame axes: reset fills the stack with the first observation, each step
    shifts the oldest out and appends the newest. The frames are
    (..., N, H, W), most recent last, as the JAX pool's state holds them."""

    def __init__(self, env: Env, num_frames: int = 4):
        super().__init__(env)
        self.num_frames = int(num_frames)

    @property
    def observation_space(self) -> Box:  # type: ignore[override]
        inner = self.env.observation_space
        return Box(low=float(np.min(np.asarray(inner.low))),
                   high=float(np.max(np.asarray(inner.high))),
                   shape=(self.num_frames,) + tuple(inner.shape),
                   dtype=inner.dtype)

    def _frame_dims(self) -> int:
        return len(self.env.observation_space.shape)

    def reset(self, keys):
        inner, obs = self.env.reset(keys)
        d = self._frame_dims()
        lead, frame = obs.shape[:obs.dim() - d], obs.shape[obs.dim() - d:]
        frames = obs.unsqueeze(-d - 1).expand(
            lead + (self.num_frames,) + frame).contiguous()
        return FrameStackState(inner, frames), frames

    def step(self, state: FrameStackState, action, key=None):
        ts = self.env.step(state.inner, action, key)
        d = self._frame_dims()
        frames = torch.cat([state.frames.narrow(-d - 1, 1, self.num_frames - 1),
                            ts.obs.unsqueeze(-d - 1)], -d - 1)
        return ts._replace(state=FrameStackState(ts.state, frames), obs=frames)

    def render(self, state: FrameStackState):
        return self.env.render(state.inner)


__all__ = ["AutoReset", "AutoResetState", "FlattenObs", "FrameStack",
           "FrameStackState", "ObsToPixels", "RewardScale", "TimeLimit",
           "TimeLimitState", "Vec", "Wrapper"]
