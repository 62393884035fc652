"""Observation/action spaces (port of `repro.core.spaces`).

Static frozen dataclasses with torch dtypes. `sample_batch` draws a whole
batch from one key, and `space.sample(key)` one element per key, with the
same threefry call sequence as the JAX package, so sampled actions match
it bit for bit. `sample` takes keys with leading axes (..., 2), as the
port's envs do, and draws one element for each: what `jax.vmap` over
`space.sample` gives in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch import random as R


class Space:
    """Abstract space."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    def sample(self, key: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Discrete(Space):
    """The integers {0..n-1}."""

    n: int
    dtype: torch.dtype = torch.int32

    @property
    def shape(self) -> Tuple[int, ...]:
        return ()

    def sample(self, key: torch.Tensor) -> torch.Tensor:
        return R.randint(key, (), 0, self.n).to(self.dtype)


@dataclasses.dataclass(frozen=True)
class Box(Space):
    """Real-valued array with per-element bounds."""

    low: Tuple[float, ...] | float
    high: Tuple[float, ...] | float
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32

    def _bounds(self):
        """float32 (low, high) broadcast to the space's shape, as numpy."""
        low = np.broadcast_to(np.asarray(self.low, np.float32), self.shape)
        high = np.broadcast_to(np.asarray(self.high, np.float32), self.shape)
        return low, high

    def sample(self, key: torch.Tensor) -> torch.Tensor:
        """`low + u * (high - low)` from one uniform per element; a
        dimension without finite bounds draws a unit normal from the same
        key instead, as the JAX package (and Gym) do."""
        low, high = self._bounds()
        finite = np.isfinite(low) & np.isfinite(high)
        with np.errstate(invalid="ignore"):     # inf - inf, selected away
            bounded = _affine(self, R.uniform(key, self.shape))
        if finite.all():
            return bounded
        return torch.where(torch.from_numpy(finite).to(key.device), bounded,
                           R.normal(key, self.shape))


def _affine(space: Box, u: torch.Tensor) -> torch.Tensor:
    """`low + u * (high - low)` in float32 over the trailing axes of `u`."""
    low, high = space._bounds()
    if (low == low.flat[0]).all() and (high == high.flat[0]).all():
        # Python scalars, so sampling makes no host-to-device copy
        return u * float(high.flat[0] - low.flat[0]) + float(low.flat[0])
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(u.device)
    return u * on(high - low) + on(low)


@dataclasses.dataclass(frozen=True)
class MultiDiscrete(Space):
    """A vector of independent Discrete axes, axis i in {0..nvec[i]-1}: the
    grid suite's cell-code observations."""

    nvec: Tuple[int, ...]
    dtype: torch.dtype = torch.int32

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self.nvec),)

    def sample(self, key: torch.Tensor) -> torch.Tensor:
        # one randint with a per-axis maxval, as the JAX package draws it
        return R.randint(key, (len(self.nvec),), 0, self.nvec)


def sample_batch(space: Space, key: torch.Tensor, batch_size: int) -> torch.Tensor:
    """Sample a batch from ONE key (one threefry stream, not B).

    `key` may carry leading batch axes (..., 2): the result is then
    (..., batch_size) + shape, one independent batch per key — the pool
    samples a whole K-step chunk of actions in one call this way.
    """
    if isinstance(space, Discrete):
        return R.randint(key, (batch_size,), 0, space.n).to(space.dtype)
    if isinstance(space, Box):
        return _affine(space, R.uniform(key, (batch_size,)
                                        + tuple(space.shape)))
    if isinstance(space, MultiDiscrete):
        # one randint with a per-axis maxval, as the JAX package draws it
        return R.randint(key, (batch_size, len(space.nvec)), 0, space.nvec)
    raise TypeError(f"sample_batch does not support {type(space).__name__}")


def flatten_space(space: Space) -> Box:
    """The FlattenObs wrapper's target space (paper §III-A.4): a Box of
    the elements, or of the one-hot codes of a discrete space."""
    if isinstance(space, Box):
        size = int(np.prod(space.shape)) if space.shape else 1
        return Box(low=-np.inf, high=np.inf, shape=(size,), dtype=space.dtype)
    if isinstance(space, Discrete):
        return Box(low=0.0, high=1.0, shape=(space.n,))
    if isinstance(space, MultiDiscrete):
        return Box(low=0.0, high=1.0, shape=(int(sum(space.nvec)),))
    raise TypeError(f"cannot flatten {type(space)}")


def _one_hot(x: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.nn.one_hot(x, n)` in float32 over a new last axis."""
    classes = torch.arange(n, device=x.device)
    return (x.unsqueeze(-1) == classes).to(torch.float32)


def flatten_obs(space: Space, obs: torch.Tensor) -> torch.Tensor:
    """Observations of `space` with any leading lane axes -> (..., size)."""
    lanes = obs.shape[:obs.dim() - len(space.shape)]
    if isinstance(space, Box):
        return obs.reshape(lanes + (-1,)).to(space.dtype)
    if isinstance(space, Discrete):
        return _one_hot(obs, space.n)
    if isinstance(space, MultiDiscrete):
        return torch.cat([_one_hot(obs[..., i], n)
                          for i, n in enumerate(space.nvec)], -1)
    raise TypeError(f"cannot flatten {type(space)}")


__all__ = ["Box", "Discrete", "MultiDiscrete", "Space", "flatten_obs",
           "flatten_space", "sample_batch"]
