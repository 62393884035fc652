"""Environment registry (port of `repro.core.registry`).

Paper Listing 2: switching a Gym experiment to CaiRL is a one-line change
(`gym.make` -> `cairl.make`). Every id is an `EnvSpec`: a core env factory,
its default construction kwargs, tags, and a declarative transform
pipeline, so the registry builds stacks from data and the fused planner
(kernels/envstep/ops.py::_plan) reads a built stack back as
`(core, transforms)`. `register_family` derives a family's `-v<N>`
(TimeLimit, or the arcade pixel pipeline), `-px` (the pixel pipeline over a
state-observing core) and `-raw` (bare core) ids from one call.

`make()` returns the functional env, with its spec on the outermost layer
(`env.spec`; `spec_of` walks wrapper stacks to it); `make_compat()` returns
the stateful Gym-API shim (core/gym_compat.py) for literal drop-in use.
`register(name, factory)` takes an opaque factory that may build any
wrapper stack itself: such an id has an empty declared pipeline.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, FrozenSet, Optional, Tuple

from repro_torch.core import pipeline as P
from repro_torch.core.env import Env


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Declarative recipe for one registry id: core factory + pipeline."""

    id: str
    core_factory: Callable[..., Env]
    transforms: Tuple[P.Transform, ...] = ()
    tags: FrozenSet[str] = frozenset()
    #: default kwargs for `core_factory`, overridable per `make()` call
    kwargs: Tuple[Tuple[str, Any], ...] = ()

    @property
    def max_steps(self) -> Optional[int]:
        """The declared TimeLimit, if any, without building anything."""
        for t in self.transforms:
            if isinstance(t, P.TimeLimit):
                return t.max_steps
        return None

    @property
    def pixels(self) -> bool:
        """True when the declared observation is the rendered framebuffer."""
        return any(isinstance(t, P.ObsToPixels) for t in self.transforms)

    def make(self, **kwargs) -> Env:
        merged = dict(self.kwargs)
        merged.update(kwargs)
        _check_kwargs(self.id, self.core_factory, merged)
        try:
            env = self.core_factory(**merged)
        except TypeError as e:
            # factories taking **kwargs pass the signature check: still
            # name the id and the kwargs
            raise TypeError(
                f"cannot build {self.id!r} with kwargs {sorted(merged)}: {e}"
            ) from e
        env = P.build_pipeline(env, self.transforms)
        env.spec = self
        return env


def _factory_name(factory) -> str:
    return getattr(factory, "__name__", repr(factory))


def _check_kwargs(env_id: str, factory, kwargs: Dict[str, Any]) -> None:
    """Reject unknown construction kwargs with a message naming them."""
    if not kwargs:
        return
    try:
        params = inspect.signature(factory).parameters
    except (TypeError, ValueError):  # builtins and other opaque callables
        return
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return
    accepted = [n for n, p in params.items()
                if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                              inspect.Parameter.KEYWORD_ONLY)]
    unknown = sorted(set(kwargs) - set(accepted))
    if unknown:
        raise TypeError(
            f"unknown kwargs {unknown} for environment {env_id!r} "
            f"({_factory_name(factory)} accepts: {accepted or 'no kwargs'})")


_REGISTRY: Dict[str, EnvSpec] = {}


def register_spec(spec: EnvSpec) -> EnvSpec:
    if spec.id in _REGISTRY:
        raise ValueError(f"environment {spec.id!r} already registered")
    _REGISTRY[spec.id] = spec
    return spec


def register(name: str, factory: Callable[..., Env], *,
             transforms: Tuple[P.Transform, ...] = (),
             tags: FrozenSet[str] = frozenset()) -> EnvSpec:
    """Register one id. With only `(name, factory)` the factory may build
    any wrapper stack itself (the Gym-style third-party API)."""
    return register_spec(EnvSpec(name, factory, tuple(transforms),
                                 frozenset(tags)))


def register_family(name: str, core_factory: Callable[..., Env], *,
                    max_steps: int, version: int = 0, obs: str = "state",
                    pixel_variant: bool = False, num_frames: int = 4,
                    tags=(), kwargs: Dict[str, Any] = None
                    ) -> Tuple[EnvSpec, ...]:
    """Register `{name}-v{version}`, `{name}-px` when `pixel_variant`, and
    `{name}-raw` (the bare core), all with `tags` and the core's default
    `kwargs`.

    `-v` is TimeLimit(max_steps); with `obs="pixels"` it is the arcade
    pipeline TimeLimit -> ObsToPixels -> FrameStack(num_frames), which is
    also what `-px` is (the grid suite's pixel mode). The pixel ids are
    tagged "pixels", the bare ones "raw".
    """
    if obs not in ("state", "pixels"):
        raise ValueError(f"obs must be 'state' or 'pixels', got {obs!r}")
    base = frozenset(tags)
    kw = tuple(sorted((kwargs or {}).items()))
    pixel_tf = (P.TimeLimit(max_steps), P.ObsToPixels(),
                P.FrameStack(num_frames))
    main_tf = pixel_tf if obs == "pixels" else (P.TimeLimit(max_steps),)
    main_tags = base | ({"pixels"} if obs == "pixels" else set())
    out = [register_spec(EnvSpec(f"{name}-v{version}", core_factory, main_tf,
                                 main_tags, kw))]
    if pixel_variant:
        out.append(register_spec(EnvSpec(f"{name}-px", core_factory, pixel_tf,
                                         base | {"pixels"}, kw)))
    out.append(register_spec(EnvSpec(f"{name}-raw", core_factory, (),
                                     base | {"raw"}, kw)))
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


def specs() -> Tuple[EnvSpec, ...]:
    """Every registered `EnvSpec`, sorted by id."""
    return tuple(_REGISTRY[n] for n in registered())


def make(name: str, **kwargs) -> Env:
    """Build an env stack by registry id (e.g. "CartPole-v1"); `kwargs`
    override the core factory's defaults."""
    return spec(name).make(**kwargs)


def spec_of(env) -> Optional[EnvSpec]:
    """The `EnvSpec` an env was built from, walking wrapper layers (e.g.
    through the `Vec(AutoReset(...))` stacks pools add)."""
    while env is not None:
        s = getattr(env, "spec", None)
        if s is not None:
            return s
        env = getattr(env, "env", None)
    return None


def make_compat(name: str, seed: int = 0, new_step_api: bool = False,
                render_mode: Optional[str] = None, device=None, **kwargs):
    """Gym drop-in: a stateful reset()/step()/render() object (Listing 2)
    on `device` (the CUDA card when None; raises if CUDA is absent).

    `new_step_api=True` returns Gym >= 0.26's 5-tuple `(obs, reward,
    terminated, truncated, info)` from `step`. `render_mode` is stored for
    call sites written for modern Gym; `render()` always returns the frame.
    """
    from repro_torch.core.gym_compat import GymCompat

    return GymCompat(make(name, **kwargs), seed=seed,
                     new_step_api=new_step_api, render_mode=render_mode,
                     device=device)


def _ensure_builtins() -> None:
    import repro_torch.envs  # noqa: F401  (registers on import)


__all__ = ["EnvSpec", "make", "make_compat", "register", "register_family",
           "register_spec", "registered", "spec", "spec_of", "specs"]
