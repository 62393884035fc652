"""The port's plain rasteriser (`repro_torch.kernels.raster.rasterize` on CPU
tensors) against the JAX package's oracle `rasterize_ref` and its Pallas
kernel in interpret mode, on numpy-seeded scenes: S = 4 (Pong) and S = 26
(Breakout) at 84×84, a non-square 16×24 frame, zero-length segments (balls,
dots) and zero-intensity padding.

Against the oracle: rtol 1e-5 / atol 1e-6 (tests/conftest.py). Against the
interpreted Pallas kernel: atol 1e-5, the tolerance at which the JAX
package holds that kernel against its own oracle
(tests/test_kernels.py::test_raster_matches_ref); the two JAX versions
differ by up to ~1e-5 on these scenes, because XLA contracts some of the
kernel's multiply-adds and the soft edge multiplies a distance's rounding
by 1/softness = H.

The CUDA kernel itself is held against this plain version on the card by
chip_smoke.py. Here: the dispatch, and that a CPU tensor never reaches it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.raster import rasterize_pallas
from repro.kernels.raster import rasterize_ref as jax_rasterize_ref
from repro_torch.kernels.raster import (capsule_scene, rasterize,
                                        rasterize_cuda, render_scene)


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CASES = {
    "pong_s4_84x84": (6, 4, 84, 84),
    "breakout_s26_84x84": (3, 26, 84, 84),
    "non_square_16x24": (5, 4, 16, 24),
}


def _scene(n, s, seed):
    """Capsules in [0, 1]², radii up to 0.05; segment 0 of every frame has
    zero length, the last one zero intensity (inert padding)."""
    rng = np.random.default_rng(seed)
    segs = rng.uniform(0.0, 1.0, (n, s, 5)).astype(np.float32)
    segs[..., 4] *= np.float32(0.05)
    segs[:, 0, 2:4] = segs[:, 0, 0:2]
    intens = rng.uniform(0.1, 1.0, (n, s)).astype(np.float32)
    intens[:, -1] = 0.0
    return segs, intens


def _plain(segs, intens, h, w):
    return rasterize(torch.from_numpy(segs), torch.from_numpy(intens), h, w)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_oracle(case):
    n, s, h, w = CASES[case]
    segs, intens = _scene(n, s, seed=len(case))
    want = np.asarray(jax_rasterize_ref(jnp.asarray(segs), jnp.asarray(intens),
                                        h, w))
    got = _plain(segs, intens, h, w)
    assert got.shape == (n, h, w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert got.max() > 0.5, "the scene must cover pixels"


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_interpret(case):
    n, s, h, w = CASES[case]
    segs, intens = _scene(n, s, seed=10 + len(case))
    want = np.asarray(rasterize_pallas(jnp.asarray(segs), jnp.asarray(intens),
                                       h, w, interpret=True))
    np.testing.assert_allclose(_plain(segs, intens, h, w).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_zero_length_and_padding():
    """A lone dot renders as a disc of its radius; a zero-intensity segment
    and an all-padding frame leave no trace."""
    h = w = 32
    segs = np.zeros((2, 2, 5), np.float32)
    segs[0, 0] = (0.5, 0.5, 0.5, 0.5, 0.1)     # a ball
    segs[0, 1] = (0.0, 0.0, 1.0, 1.0, 0.3)     # a fat diagonal, intensity 0
    intens = np.array([[0.9, 0.0], [0.0, 0.0]], np.float32)
    got = _plain(segs, intens, h, w).numpy()
    want = np.asarray(jax_rasterize_ref(jnp.asarray(segs), jnp.asarray(intens),
                                        h, w))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got[0].max() == np.float32(0.9) and got[0, 0, 0] == 0.0
    assert not got[1].any()
    alone = _plain(segs[:, :1], intens[:, :1], h, w).numpy()
    np.testing.assert_array_equal(got, alone)


def test_single_and_leading_axes():
    segs, intens = _scene(6, 4, seed=3)
    t_segs, t_int = torch.from_numpy(segs), torch.from_numpy(intens)
    batched = rasterize(t_segs, t_int, 20, 30)
    assert torch.equal(render_scene(t_segs[2], t_int[2], 20, 30), batched[2])
    lead = render_scene(t_segs.reshape(2, 3, 4, 5), t_int.reshape(2, 3, 4),
                        20, 30)
    assert torch.equal(lead, batched.reshape(2, 3, 20, 30))


def test_capsule_scene_fills_constants():
    like = torch.arange(3, dtype=torch.float32)
    segs, intens = capsule_scene(like, [(0.5, like, 0.5, like + 1, 0.02)],
                                 (0.7,))
    assert segs.shape == (3, 1, 5) and intens.shape == (3, 1)
    assert torch.equal(segs[:, 0, 1], like) and torch.equal(
        segs[:, 0, 0], torch.full((3,), 0.5))
    assert torch.equal(intens[:, 0], torch.full((3,), 0.7))


def test_dispatch_on_cpu_tensors():
    """"auto" and "torch" take the plain version for CPU tensors; "cuda"
    and the kernel's wrapper raise."""
    segs, intens = _scene(2, 4, seed=5)
    t_segs, t_int = torch.from_numpy(segs), torch.from_numpy(intens)
    want = rasterize(t_segs, t_int, 8, 8, backend="torch")
    assert torch.equal(rasterize(t_segs, t_int, 8, 8, backend="auto"), want)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rasterize(t_segs, t_int, 8, 8, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        rasterize_cuda(t_segs, t_int, 8, 8)
    with pytest.raises(ValueError, match="unknown backend"):
        rasterize(t_segs, t_int, 8, 8, backend="pallas")
