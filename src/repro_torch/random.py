"""Legacy `jax.random` in PyTorch: threefry-2x32 keys with the same bits.

The committed golden traces (tests/golden/) and every parity test against
the JAX package depend on the exact random stream, so this is a bit-exact
port of JAX's *non-partitionable* threefry layout (`jax.random` under
`jax.threefry_partitionable(False)`): `PRNGKey`, `split`, `fold_in`,
`uniform`, `bernoulli` and `randint`. `normal` draws the same uniforms and
is within a few ulps of JAX's (see `erf_inv`).

A key is an int64 tensor whose last axis holds the two uint32 words
`(..., 2)`; any leading axes are a batch of independent keys, so one call
does what `jax.vmap` over keys does in the JAX package. int64 is used
because PyTorch has no shifts on uint32 tensors: every add, shift and
multiply is masked back to 32 bits. Keys are the only int64 leaves of a pool
state, which is how `state_dict` finds the leaves to hand out as uint32.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.numerics import f32, sqrt

KEY_DTYPE = torch.int64
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Device = Union[str, torch.device, None]


def PRNGKey(seed: int, device: Device = None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)`: the (2,) key `[0, seed mod 2**32]`.

    Built with fills, not a host copy, so it makes no host-device sync.
    """
    key = torch.zeros(2, dtype=KEY_DTYPE, device=device)
    key[1] = int(seed) & _MASK
    return key


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry-2x32 block (jax `threefry2x32_p`), elementwise over
    broadcast int64 operands holding uint32 values: 20 rounds, 5 key
    injections."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + k1) & _MASK
    x1 = (x1 + k2) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def threefry_2x32(key: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """jax `threefry_2x32(key, count)` over the last axis of `count`.

    The count vector is cut into two *halves* (not interleaved pairs), an
    odd length padded with one zero; the output is `concat(y0, y1)` trimmed
    back to the count's length. `key` (..., 2) broadcasts against the
    count's leading axes.
    """
    n = count.shape[-1]
    if n % 2:
        count = torch.cat([count, count.new_zeros(count.shape[:-1] + (1,))], -1)
    h = count.shape[-1] // 2
    k1, k2 = key[..., 0:1], key[..., 1:2]
    y0, y1 = threefry2x32(k1, k2, count[..., :h], count[..., h:])
    return torch.cat([y0, y1], -1)[..., :n]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split`: (..., 2) keys -> (..., num, 2) keys."""
    counts = torch.arange(num * 2, dtype=KEY_DTYPE, device=key.device)
    bits = threefry_2x32(key, counts)
    return bits.reshape(key.shape[:-1] + (num, 2))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`: hash `data` (an int, or an int tensor that
    broadcasts against the key's batch axes) into the key."""
    if not isinstance(data, torch.Tensor):
        data = torch.full((), int(data) & _MASK, dtype=KEY_DTYPE,
                          device=key.device)
    data = data.to(KEY_DTYPE) & _MASK
    k1, k2 = key[..., 0], key[..., 1]
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), -1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (jax `_threefry_random_bits_original`):
    (..., 2) keys -> (...,) + shape int64 values in [0, 2**32)."""
    shape = tuple(shape)
    size = math.prod(shape)
    counts = torch.arange(size, dtype=KEY_DTYPE, device=key.device)
    bits = threefry_2x32(key, counts)
    return bits.reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform` in float32 with scalar bounds.

    The mantissa of `1.0` is filled with the top 23 random bits, 1 is
    subtracted, then the value is scaled by `maxval - minval` (a float32
    difference, as JAX takes it), shifted by `minval` and clamped below at
    `minval`.
    """
    bits = random_bits(key, shape)
    one_to_two = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo, hi = f32(minval), f32(maxval)
    span = float(np.float32(hi) - np.float32(lo))
    return ((one_to_two - 1.0) * span + lo).clamp_min(lo)


#: XLA's float32 ErfInv polynomial (chlo.erf_inv): 9 coefficients, highest
#: power first, for w = -log1p(-x²) < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in float32, rounded once, on every device: the float32
    product is exact in float64, so only the sum rounds (and then to
    float32, a double rounding that differs from a true FMA with odds of
    about 2**-29)."""
    return (a.double() * b.double() + c.double()).float()


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 `ErfInv`, op by op (`jax.lax.erf_inv`), with its
    Horner steps as FMAs, as XLA's CPU backend contracts them.

    Not `torch.erfinv`, which is another approximation. `log1p` is
    PyTorch's, which is not XLA's, so a few lanes differ from JAX by a few
    ulps (tests/test_torch_random.py states the bound).
    """
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt(w) - 3.0)
    coeff = lambda i: torch.where(lt, f32(_ERFINV_LT5[i]), f32(_ERFINV_GE5[i]))
    p = coeff(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coeff(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """`jax.random.normal` in float32: `sqrt(2) * erf_inv(u)` with u
    uniform on [nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return f32(math.sqrt(2.0)) * erf_inv(uniform(key, shape, lo, 1.0))


def bernoulli(key: torch.Tensor, p: float = 0.5,
              shape: Sequence[int] = ()) -> torch.Tensor:
    """`jax.random.bernoulli` with a scalar `p`: `uniform(key, shape) < p`,
    p rounded to float32 as JAX takes it."""
    return uniform(key, shape) < f32(p)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval) -> torch.Tensor:
    """`jax.random.randint` into int32 with a scalar `minval`.

    Two 32-bit draws per element from the two halves of `split(key)`,
    combined modulo the span in wrapping uint32 arithmetic. `maxval` is an
    int, a sequence of ints that broadcasts against the trailing axes of
    `shape` (a `MultiDiscrete` space's `nvec`), or an int32 tensor that
    broadcasts so (the replay's `max(size, 1)`): its span is computed on
    its device, so a tensor bound makes no host sync.
    """
    minval = int(minval)
    keys = split(key)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    if isinstance(maxval, torch.Tensor):
        span, multiplier = _span_tensor(minval, maxval.to(key.device))
    elif isinstance(maxval, (int, np.integer)):
        span, multiplier = _span(minval, int(maxval))
    else:
        pairs = [_span(minval, int(m)) for m in maxval]
        span, multiplier = (torch.tensor(x, dtype=KEY_DTYPE, device=key.device)
                            for x in zip(*pairs))
    offset = ((higher % span) * multiplier + lower % span) & _MASK
    return (offset % span + minval).to(torch.int32)


def _span(minval: int, maxval: int) -> Tuple[int, int]:
    """randint's span (1 when the range is empty) and its multiplier,
    `(2**16 mod span)**2 mod span` with the square wrapped to 32 bits as
    JAX's uint32 arithmetic wraps it: 0, not 2**32 mod span, for spans
    above 2**16."""
    span = (maxval - minval) & _MASK if maxval > minval else 1
    multiplier = (2 ** 16) % span
    return span, ((multiplier * multiplier) & _MASK) % span


def _span_tensor(minval: int, maxval: torch.Tensor):
    """`_span` of an int32 tensor `maxval`, on its device."""
    if maxval.dtype != torch.int32:
        raise ValueError(f"randint takes an int32 tensor maxval, not "
                         f"{maxval.dtype}")
    m = maxval.to(KEY_DTYPE)
    span = torch.where(m > minval, (m - minval) & _MASK, 1)
    multiplier = (2 ** 16) % span
    return span, ((multiplier * multiplier) & _MASK) % span


__all__ = ["KEY_DTYPE", "PRNGKey", "bernoulli", "erf_inv", "fold_in",
           "normal", "randint", "random_bits", "split", "threefry_2x32",
           "uniform"]
