"""The port's threefry (`repro_torch.random`) against `jax.random`.

The JAX side runs in the legacy, non-partitionable threefry layout the
committed goldens were made with (`jax.threefry_partitionable(False)`,
scoped, never a global flag). Keys, splits, fold-ins, raw bits and randint
draws must be equal as uint32. Sizes 1, 3 and 5 hit the odd-length padding
of the half-split count vector.

`uniform` on the CPU: XLA's CPU backend may fuse the final
`u * (maxval - minval) + minval` into one fused multiply-add where it
vectorises, so its last bit depends on the shape. The port rounds the
multiply and the add apart, as the HLO states them. So `uniform` is held
bit-exact on [0, 1) (the pools' Box sampling: multiply by one, add zero)
and against the unfused HLO arithmetic in numpy, and within one float32
ulp of the bounds' magnitude of JAX on other ranges.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as R

SEEDS = (0, 1, 42, 2**31 - 1, -1, 797)
SIZES = (1, 3, 4, 5)


def _t(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint32)


def _batched_keys(n=5):
    with jax.threefry_partitionable(False):
        return jax.random.split(jax.random.PRNGKey(11), n)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    with jax.threefry_partitionable(False):
        want = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(_u32(R.PRNGKey(seed)), _u32(want))


@pytest.mark.parametrize("num", (2, 3, 5))
def test_split_single_and_batched(num):
    keys = _batched_keys()
    with jax.threefry_partitionable(False):
        one = jax.random.split(keys[0], num)
        many = jax.vmap(lambda k: jax.random.split(k, num))(keys)
    np.testing.assert_array_equal(_u32(R.split(_t(keys[0]), num)), _u32(one))
    np.testing.assert_array_equal(_u32(R.split(_t(keys), num)), _u32(many))


def test_fold_in_ints_and_tensors():
    keys = _batched_keys()
    data = np.array([0, 1, 0x57EB, 0x5EED, 2**32 - 1], np.uint32)
    with jax.threefry_partitionable(False):
        per_int = [jax.random.fold_in(keys[0], int(d)) for d in data]
        per_lane = jax.vmap(jax.random.fold_in)(keys, jnp.asarray(data))
        one_key = jax.vmap(lambda d: jax.random.fold_in(keys[0], d))(
            jnp.arange(1, 9))
    for d, want in zip(data, per_int):
        np.testing.assert_array_equal(_u32(R.fold_in(_t(keys[0]), int(d))),
                                      _u32(want))
    np.testing.assert_array_equal(
        _u32(R.fold_in(_t(keys), torch.from_numpy(data.astype(np.int64)))),
        _u32(per_lane))
    np.testing.assert_array_equal(
        _u32(R.fold_in(_t(keys[0]), torch.arange(1, 9))), _u32(one_key))


@pytest.mark.parametrize("n", SIZES)
def test_random_bits(n):
    keys = _batched_keys()
    with jax.threefry_partitionable(False):
        want = jax.vmap(lambda k: jax.random.bits(k, (n,), jnp.uint32))(keys)
    np.testing.assert_array_equal(_u32(R.random_bits(_t(keys), (n,))),
                                  _u32(want))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("span", (2, 3, 7, 1000))
def test_randint(n, span):
    keys = _batched_keys()
    with jax.threefry_partitionable(False):
        one = jax.random.randint(keys[0], (n,), 0, span)
        many = jax.vmap(lambda k: jax.random.randint(k, (n,), 0, span))(keys)
    got_one = R.randint(_t(keys[0]), (n,), 0, span)
    assert got_one.dtype == torch.int32
    np.testing.assert_array_equal(got_one.numpy(), np.asarray(one))
    np.testing.assert_array_equal(
        R.randint(_t(keys), (n,), 0, span).numpy(), np.asarray(many))


@pytest.mark.parametrize("shape", ((), (1,), (3,), (5,), (2, 3)))
def test_uniform_unit_interval_bit_exact(shape):
    keys = _batched_keys()
    with jax.threefry_partitionable(False):
        want = jax.vmap(lambda k: jax.random.uniform(k, shape))(keys)
    got = R.uniform(_t(keys), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == (5,) + shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


@pytest.mark.parametrize("bounds", ((-0.05, 0.05), (-0.6, -0.4),
                                    (-np.pi, np.pi), (-0.1, 0.1)))
@pytest.mark.parametrize("n", SIZES)
def test_uniform_ranges(bounds, n):
    lo, hi = bounds
    keys = _batched_keys()
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, (n,), minval=lo, maxval=hi))(keys))
        unit = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys))
    got = R.uniform(_t(keys), (n,), lo, hi).numpy()
    # the HLO's own arithmetic, each op rounded to float32 apart
    lo32, hi32 = np.float32(lo), np.float32(hi)
    hlo = np.maximum(lo32, unit * (hi32 - lo32) + lo32)
    np.testing.assert_array_equal(got.view(np.uint32), hlo.view(np.uint32))
    # an FMA rounds the product once less: at most one ulp of the bounds
    ulp = np.spacing(np.float32(max(abs(lo), abs(hi))))
    np.testing.assert_allclose(got, want, rtol=0, atol=ulp)
