"""Environment protocol (port of `repro.core.env`).

An `Env` holds only static configuration; its dynamics are functions of an
explicit state. Unlike the JAX package, whose envs step one lane and are
batched by `vmap`, every env here is batch-native: `reset(keys)` takes keys
of shape (..., 2) and returns a state NamedTuple whose leaves carry the same
leading axes, and `step` advances every lane at once. `step` takes the
per-step key as the JAX package's does, one key per lane (..., 2); envs
whose dynamics draw no random numbers ignore it, so it defaults to None.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.core.spaces import Space


class Timestep(NamedTuple):
    """One batched transition. `done` folds termination and truncation;
    `TimeLimit` keeps them apart through `info["truncated"]`."""

    state: Any
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    info: Dict[str, torch.Tensor]


class Env:
    """Base environment.

    Contract:
      reset(keys (..., 2))       -> (state, obs (..., O))
      step(state, action, keys)  -> Timestep over the same lanes
      render(state)         -> (..., H, W) float32 frames in [0, 1]

    An env with a renderer declares `frame_shape = (H, W)` and a capsule
    `scene(state)` (see kernels/raster); `render` rasterises it.
    """

    observation_space: Space
    action_space: Space
    #: the `EnvSpec` this env was built from, when it came out of the
    #: registry (`registry.make` sets it on the outermost layer;
    #: `registry.spec_of` walks wrapper stacks to find it)
    spec = None

    def reset(self, keys: torch.Tensor) -> Tuple[Any, torch.Tensor]:
        raise NotImplementedError

    def step(self, state: Any, action: torch.Tensor,
             key: torch.Tensor = None) -> Timestep:
        raise NotImplementedError

    def render(self, state: Any) -> torch.Tensor:
        if not hasattr(self, "scene"):
            raise NotImplementedError(f"{type(self).__name__} has no renderer")
        from repro_torch.kernels.raster import render_scene

        return render_scene(*self.scene(state), *self.frame_shape)

    def fused_step(self, state: Any, actions: torch.Tensor,
                   num_steps: int = None, *, backend: str = "auto",
                   active: torch.Tensor = None):
        """Advance a batched `AutoReset` state by `num_steps` steps in one
        megastep launch (repro_torch.kernels.envstep.fused_step).

        Returns `(new_state, Timestep)` with a leading step axis on the
        Timestep leaves. `active` is an optional (B,) bool lane mask (the
        async pool's masked step): inactive lanes keep their state and key
        and report zero outputs. Raises NotImplementedError for a stack
        without a fused spec; probe with `supports_fused_step(env)`.
        """
        from repro_torch.kernels.envstep import fused_step as _fused_step

        return _fused_step(self, state, actions, num_steps=num_steps,
                           backend=backend, active=active)

    @property
    def name(self) -> str:
        return type(self).__name__

    @property
    def unwrapped(self) -> "Env":
        return self

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}()"


def supports_fused_step(env: Env) -> bool:
    """True if `env.fused_step` will run for this stack."""
    from repro_torch.kernels.envstep import supports

    return supports(env)


def zeros_info() -> Dict[str, torch.Tensor]:
    """The info dict of an env that reports nothing: a fixed structure, so
    a loop over steps carries the same keys every step."""
    return {}


def terminal_timestep(env: Env, state, obs) -> Timestep:
    """A done, zero-reward `Timestep` over `obs`'s lanes (the lane axes
    are those of `obs` less the env's observation axes)."""
    lanes = obs.shape[:obs.dim() - len(env.observation_space.shape)]
    return Timestep(
        state=state, obs=obs,
        reward=torch.zeros(lanes, dtype=torch.float32, device=obs.device),
        done=torch.ones(lanes, dtype=torch.bool, device=obs.device),
        info=zeros_info())
