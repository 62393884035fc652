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


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


#: `normal` against `jax.random.normal`: the port's `erf_inv` is XLA's
#: float32 polynomial with the Horner steps as FMAs, but its `log1p` is
#: PyTorch's, so some lanes differ. Measured over 5 keys × 10^5 lanes
#: (jax 0.9.0 CPU, torch 2.13.0 CPU): 0.89% to 0.99% of lanes differ, by at
#: most 3 ulps. The bound is that maximum, and twice that share.
NORMAL_MAX_ULPS = 3
NORMAL_MAX_SHARE = 0.02


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 steps between same-signed finite values."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("shape", ((4096,), (3, 37), ()))
def test_normal_within_stated_ulps(shape):
    keys = _batched_keys(3)
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, shape))(keys))
    got = R.normal(_t(keys), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3,) + shape
    got = got.numpy()
    assert np.all(np.sign(got) == np.sign(want))
    ulps = _ulps(got, want)
    assert ulps.max() <= NORMAL_MAX_ULPS, ulps.max()
    assert (ulps > 0).mean() <= NORMAL_MAX_SHARE, (ulps > 0).mean()


def test_erf_inv_tails_and_poles():
    """Both branches of the polynomial (w < 5 and w >= 5) and the poles."""
    x = np.float32([-1.0, -0.9999999, -0.99999, -0.9, -0.3, 0.0, 1e-8, 0.5,
                    0.993, 0.99999, 0.9999999, 1.0])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = R.erf_inv(torch.from_numpy(x)).numpy()
    assert np.isinf(got[0]) and got[0] < 0 and np.isinf(got[-1]) and got[-1] > 0
    np.testing.assert_allclose(got, want, rtol=NORMAL_MAX_ULPS * 2.0 ** -23,
                               atol=0)


@pytest.mark.parametrize("n", (1, 5, 32))
@pytest.mark.parametrize("maxval", (0, 1, 2, 7, 96, 50_000, 2**31 - 1))
def test_randint_tensor_maxval(n, maxval):
    """A traced int32 bound (the replay's `max(size, 1)`) draws what JAX
    draws for it, bit for bit, and so does the same bound as an int; 0 is
    an empty range (always minval). Spans above 2**16 need JAX's wrapped
    multiplier (0): an unwrapped 2**32 mod span drew other numbers."""
    keys = _batched_keys()
    with jax.threefry_partitionable(False):
        bound = jnp.asarray(maxval, jnp.int32)
        want = jax.vmap(lambda k: jax.random.randint(k, (n,), 0, bound))(keys)
    got = R.randint(_t(keys), (n,), 0, torch.tensor(maxval, dtype=torch.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(R.randint(_t(keys), (n,), 0, maxval).numpy(),
                                  np.asarray(want))
    with pytest.raises(ValueError, match="int32"):
        R.randint(_t(keys), (n,), 0, torch.tensor(maxval, dtype=torch.int64))


#: `categorical`'s Gumbel noise, -log(-log(u)), takes PyTorch's `log`,
#: which is not XLA's: about 23% of the noise values differ from JAX's by
#: an ulp (jax 0.9.0 CPU, torch 2.13.0 CPU), and an action differs only
#: where two noised logits lie within that ulp. Measured over 10^5 draws
#: (this test's 5 keys × 20,000 rows of 5 logits N(0, 1) times 3, 0.01 and
#: 1e-5): no action differed. The bound is ten in 10^5.
CATEGORICAL_MAX_SHARE = 1e-4


def test_categorical_actions_match_jax():
    keys = _batched_keys(5)
    with jax.threefry_partitionable(False):
        logits = np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                              (20000, 5))) * 3
        want = np.asarray(jax.jit(jax.vmap(
            lambda k: jax.random.categorical(k, logits)))(keys))
    got = torch.stack([R.categorical(_t(k), torch.from_numpy(logits))
                       for k in keys])
    assert got.dtype == torch.int64 and tuple(got.shape) == want.shape
    assert (got.numpy() != want).mean() <= CATEGORICAL_MAX_SHARE
    # the first index wins a tie, as in jnp.argmax
    tie = torch.zeros(64, 3)
    tie[:, 1:] = float("inf")
    assert (R.categorical(_t(keys[0]), tie) == 1).all()


@pytest.mark.parametrize("n", (1, 5, 64, 2048))
def test_permutation_matches_jax(n):
    """JAX's sort-based shuffle: one round of 32-bit keys up to n = 64...,
    two at n = 2,048 (PPOConfig()'s 16 × 128 minibatch pool)."""
    keys = _batched_keys(3)
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n))(keys))
    got = torch.stack([R.permutation(_t(k), n) for k in keys])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert sorted(got[0].tolist()) == list(range(n))
