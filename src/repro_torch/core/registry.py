"""Environment registry (port of `repro.core.registry`).

Every id is an `EnvSpec`: a core env factory plus a declarative transform
pipeline. `register_family` derives a family's `-v<N>` (TimeLimit, or the
arcade pixel pipeline) and `-raw` (bare core) ids from one call. The pixel
`-px` ids, construction kwargs and the legacy `register(name, factory)` shim
come with later slices.
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
                    obs: str = "state") -> Tuple[EnvSpec, ...]:
    """Register `{name}-v{version}` and `{name}-raw` (the bare core).

    `-v` is TimeLimit(max_steps); with `obs="pixels"` it is the arcade
    pipeline TimeLimit -> ObsToPixels -> FrameStack(4).
    """
    if obs not in ("state", "pixels"):
        raise ValueError(f"obs must be 'state' or 'pixels', got {obs!r}")
    main = (P.TimeLimit(max_steps),)
    if obs == "pixels":
        main += (P.ObsToPixels(), P.FrameStack(4))
    return (
        register_spec(EnvSpec(f"{name}-v{version}", core_factory, main)),
        register_spec(EnvSpec(f"{name}-raw", core_factory)),
    )


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
