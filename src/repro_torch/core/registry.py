"""Environment registry (port of `repro.core.registry`).

Every id is an `EnvSpec`: a core env factory plus a declarative transform
pipeline. `register_family` derives a family's `-v<N>` (TimeLimit, or the
arcade pixel pipeline), `-px` (the pixel pipeline over a state-observing
core) and `-raw` (bare core) ids from one call. Construction kwargs and the
legacy `register(name, factory)` shim come with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from repro_torch.core import pipeline as P
from repro_torch.core.env import Env


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Declarative recipe for one registry id: core factory + pipeline."""

    id: str
    core_factory: Callable[[], Env]
    transforms: Tuple[P.Transform, ...] = ()

    def make(self) -> Env:
        return P.build_pipeline(self.core_factory(), self.transforms)


_REGISTRY: Dict[str, EnvSpec] = {}


def register_spec(spec: EnvSpec) -> EnvSpec:
    if spec.id in _REGISTRY:
        raise ValueError(f"environment {spec.id!r} already registered")
    _REGISTRY[spec.id] = spec
    return spec


def register_family(name: str, core_factory: Callable[[], Env], *,
                    max_steps: int, version: int = 0,
                    obs: str = "state",
                    pixel_variant: bool = False) -> Tuple[EnvSpec, ...]:
    """Register `{name}-v{version}`, `{name}-px` when `pixel_variant`, and
    `{name}-raw` (the bare core).

    `-v` is TimeLimit(max_steps); with `obs="pixels"` it is the arcade
    pipeline TimeLimit -> ObsToPixels -> FrameStack(4), which is also what
    `-px` is (the grid suite's pixel mode).
    """
    if obs not in ("state", "pixels"):
        raise ValueError(f"obs must be 'state' or 'pixels', got {obs!r}")
    pixels = (P.TimeLimit(max_steps), P.ObsToPixels(), P.FrameStack(4))
    main = pixels if obs == "pixels" else (P.TimeLimit(max_steps),)
    out = [register_spec(EnvSpec(f"{name}-v{version}", core_factory, main))]
    if pixel_variant:
        out.append(register_spec(EnvSpec(f"{name}-px", core_factory, pixels)))
    out.append(register_spec(EnvSpec(f"{name}-raw", core_factory)))
    return tuple(out)


def registered() -> list:
    _ensure_builtins()
    return sorted(_REGISTRY)


def spec(name: str) -> EnvSpec:
    """The `EnvSpec` behind a registered id."""
    _ensure_builtins()
    if name not in _REGISTRY:
        raise KeyError(f"unknown environment {name!r}; known: {registered()}")
    return _REGISTRY[name]


def make(name: str) -> Env:
    """Build an env stack by registry id (e.g. "CartPole-v1")."""
    return spec(name).make()


def _ensure_builtins() -> None:
    import repro_torch.envs  # noqa: F401  (registers on import)


__all__ = ["EnvSpec", "make", "register_family", "register_spec",
           "registered", "spec"]
