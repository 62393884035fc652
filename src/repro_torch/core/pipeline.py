"""Declarative env pipelines (port of `repro.core.pipeline`).

A `Transform` is the data of one wrapper application (`TimeLimit(500)`), so
the registry builds stacks from it and the fused planner
(kernels/envstep/ops.py::_plan) reads a built stack back as
`(core, transforms)` instead of inspecting wrapper classes. Each transform
carries its fusion role, the part of the fused step that models it;
`FlattenObs` and `RewardScale` have none, so a stack holding one steps on
the vmap path.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple, Type

from repro_torch.core import wrappers as _w
from repro_torch.core.env import Env

#: fusion roles the megastep planner understands (kernels/envstep/ops.py)
FUSION_TIME_LIMIT = "time_limit"
FUSION_PIXELS = "pixels"
FUSION_FRAME_STACK = "frame_stack"


@dataclasses.dataclass(frozen=True)
class Transform:
    """One declarative wrapper application. Frozen, hashable, rebuildable."""

    wrapper: ClassVar[Type[_w.Wrapper]]
    fusion: ClassVar[Optional[str]] = None

    def build(self, env: Env) -> Env:
        return self.wrapper(env, **{f.name: getattr(self, f.name)
                                    for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class TimeLimit(Transform):
    """Truncate episodes at `max_steps` (wrappers.TimeLimit)."""

    max_steps: int
    wrapper = _w.TimeLimit
    fusion = FUSION_TIME_LIMIT


@dataclasses.dataclass(frozen=True)
class ObsToPixels(Transform):
    """Observe the rendered framebuffer (wrappers.ObsToPixels)."""

    wrapper = _w.ObsToPixels
    fusion = FUSION_PIXELS


@dataclasses.dataclass(frozen=True)
class FrameStack(Transform):
    """Stack the last `num_frames` observations (wrappers.FrameStack)."""

    num_frames: int = 4
    wrapper = _w.FrameStack
    fusion = FUSION_FRAME_STACK


@dataclasses.dataclass(frozen=True)
class FlattenObs(Transform):
    """Flatten observations to a 1-D Box (wrappers.FlattenObs)."""

    wrapper = _w.FlattenObs


@dataclasses.dataclass(frozen=True)
class RewardScale(Transform):
    """Scale rewards by a static factor (wrappers.RewardScale)."""

    scale: float
    wrapper = _w.RewardScale


def build_pipeline(env: Env, transforms: Tuple[Transform, ...]) -> Env:
    """Apply transforms innermost-first."""
    for t in transforms:
        env = t.build(env)
    return env


#: built wrapper -> its Transform
_FROM_WRAPPER = {
    _w.TimeLimit: lambda w: TimeLimit(w.max_steps),
    _w.ObsToPixels: lambda w: ObsToPixels(),
    _w.FrameStack: lambda w: FrameStack(w.num_frames),
    _w.FlattenObs: lambda w: FlattenObs(),
    _w.RewardScale: lambda w: RewardScale(w.scale),
}


def transform_of(wrapper: _w.Wrapper) -> Optional[Transform]:
    """The Transform that rebuilds `wrapper`, or None if it is opaque."""
    fn = _FROM_WRAPPER.get(type(wrapper))
    return fn(wrapper) if fn is not None else None


def declared_pipeline(env: Env):
    """Walk a built stack back to `(core_env, transforms)` (innermost-first),
    or `(None, None)` when a wrapper in it is opaque (AutoReset and Vec are
    applied by pools and are opaque here, as in the JAX package)."""
    transforms = []
    while isinstance(env, _w.Wrapper):
        t = transform_of(env)
        if t is None:
            return None, None
        transforms.append(t)
        env = env.env
    return env, tuple(reversed(transforms))


__all__ = ["FUSION_FRAME_STACK", "FUSION_PIXELS", "FUSION_TIME_LIMIT",
           "FlattenObs", "FrameStack", "ObsToPixels", "RewardScale",
           "TimeLimit", "Transform",
           "build_pipeline", "declared_pipeline", "transform_of"]
