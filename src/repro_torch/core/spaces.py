"""Observation/action spaces (port of `repro.core.spaces`).

Static frozen dataclasses with torch dtypes. `sample_batch` draws a whole
batch from one key with the same threefry call sequence as the JAX package,
so sampled actions match it bit for bit.
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


@dataclasses.dataclass(frozen=True)
class Discrete(Space):
    """The integers {0..n-1}."""

    n: int
    dtype: torch.dtype = torch.int32

    @property
    def shape(self) -> Tuple[int, ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class Box(Space):
    """Real-valued array with per-element bounds."""

    low: Tuple[float, ...] | float
    high: Tuple[float, ...] | float
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class MultiDiscrete(Space):
    """A vector of independent Discrete axes, axis i in {0..nvec[i]-1}: the
    grid suite's cell-code observations."""

    nvec: Tuple[int, ...]
    dtype: torch.dtype = torch.int32

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self.nvec),)


def sample_batch(space: Space, key: torch.Tensor, batch_size: int) -> torch.Tensor:
    """Sample a batch from ONE key (one threefry stream, not B).

    `key` may carry leading batch axes (..., 2): the result is then
    (..., batch_size) + shape, one independent batch per key — the pool
    samples a whole K-step chunk of actions in one call this way.
    """
    if isinstance(space, Discrete):
        return R.randint(key, (batch_size,), 0, space.n).to(space.dtype)
    if isinstance(space, Box):
        shape = (batch_size,) + tuple(space.shape)
        low = np.broadcast_to(np.asarray(space.low, np.float32), space.shape)
        span = np.broadcast_to(np.asarray(space.high, np.float32), space.shape) - low
        if not ((low == low.flat[0]).all() and (span == span.flat[0]).all()):
            raise NotImplementedError(
                "sample_batch takes Box spaces with one bound for every "
                "element; per-element bounds come with a later slice")
        # Python scalars, so sampling makes no host-to-device copy.
        return R.uniform(key, shape) * float(span.flat[0]) + float(low.flat[0])
    if isinstance(space, MultiDiscrete):
        # one randint with a per-axis maxval, as the JAX package draws it
        return R.randint(key, (batch_size, len(space.nvec)), 0, space.nvec)
    raise TypeError(f"sample_batch does not support {type(space).__name__}")


__all__ = ["Box", "Discrete", "MultiDiscrete", "Space", "sample_batch"]
