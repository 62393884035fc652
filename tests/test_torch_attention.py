"""The port's attention and layers against the JAX package, on the CPU.

`repro_torch.kernels.attention.ref.attention_ref` (the plain version the
CUDA kernel is held against on the card) against JAX's `attention_ref` and
its Pallas kernel in interpret mode, over the sweep of
tests/test_kernels.py plus the cases the LM path needs (a query offset,
Lq != Lk, head dim 80, bf16); `_attend_chunked` against JAX's; the
building blocks of models/layers.py. Inputs are numpy draws from a seed.
Tolerances are the JAX package's own: 3e-5 for f32 attention, 5e-2 for
bf16 (tests/test_kernels.py), 1e-5/1e-6 for the layers
(tests/conftest.py::assert_leaves_match).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.flash import flash_attention
from repro.kernels.attention.ref import attention_ref as jax_attention_ref
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention.flash import flash_attention_cuda
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.models import attention as torch_attention
from repro_torch.models import layers


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


F32_TOL = dict(rtol=3e-5, atol=3e-5)      # tests/test_kernels.py
BF16_TOL = dict(rtol=5e-2, atol=5e-2)     # tests/test_kernels.py
LAYER_TOL = dict(rtol=1e-5, atol=1e-6)    # tests/conftest.py

# the JAX references, jitted: one compile per shape instead of one per op
jax_ref = jax.jit(jax_attention_ref, static_argnames=("causal", "window", "q_offset"))
jax_chunked = jax.jit(jax_attention._attend_chunked,
                      static_argnames=("causal", "window", "q_offset", "q_chunk"))


def qkv(seed, b, hq, hkv, lq, lk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, lq, d), np.float32),
            rng.standard_normal((b, hkv, lk, d), np.float32),
            rng.standard_normal((b, hkv, lk, d), np.float32))


def as_torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("hq,hkv,l,d", [(4, 4, 32, 16), (4, 2, 64, 32), (8, 1, 32, 64)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8), (False, 0)])
def test_attention_ref_matches_jax_and_pallas_sweep(hq, hkv, l, d, causal, window):
    q, k, v = qkv(hq * 1000 + l, 2, hq, hkv, l, l, d)
    got = attention_ref(*as_torch(q, k, v), causal=causal, window=window).numpy()
    ref = jax_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(ref), **F32_TOL)
    pallas = flash_attention(q, k, v, causal=causal, window=window,
                             block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **F32_TOL)


@pytest.mark.parametrize("hq,hkv,lq,lk,d,causal,window,q_offset", [
    (4, 2, 5, 24, 16, True, 0, 7),        # cached prefill: q_offset > 0
    (4, 2, 1, 40, 32, True, 0, 29),       # scalar decode over a cache
    (4, 4, 9, 33, 80, True, 6, 20),       # D = 80, a window, ragged lengths
    (2, 1, 17, 17, 80, False, 0, 0),      # non-causal, D = 80
    (8, 2, 3, 50, 64, True, 0, 100),      # every key visible (offset past Lk)
    (4, 2, 4, 12, 16, True, 3, 30),       # rows with no visible key -> 0
])
def test_attention_ref_offsets_and_ragged_lengths(hq, hkv, lq, lk, d, causal,
                                                  window, q_offset):
    q, k, v = qkv(lq * 100 + lk, 2, hq, hkv, lq, lk, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = attention_ref(*as_torch(q, k, v), **kw).numpy()
    ref = np.asarray(jax_ref(q, k, v, **kw))
    np.testing.assert_allclose(got, ref, **F32_TOL)
    if window and q_offset >= lk + window:
        assert not got.any()


def test_attention_ref_bf16():
    q, k, v = qkv(0, 1, 4, 2, 32, 40, 32)
    tq, tk, tv = as_torch(q, k, v, dtype=torch.bfloat16)
    got = attention_ref(tq, tk, tv, causal=True, q_offset=8)
    assert got.dtype == torch.bfloat16
    to_jax = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    ref = jax_ref(to_jax(tq), to_jax(tk), to_jax(tv), causal=True, q_offset=8)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               **BF16_TOL)


@pytest.mark.parametrize("lq,lk,window,q_offset,q_chunk", [
    (24, 24, 0, 0, 8),        # JAX chunks the queries; the port does not
    (6, 30, 0, 11, 512),      # cached prefill
    (1, 30, 0, 17, 512),      # scalar decode
    (20, 20, 8, 0, 5),        # SWA prefill
])
def test_attend_chunked_matches_jax(lq, lk, window, q_offset, q_chunk):
    q, k, v = qkv(lq + lk, 2, 4, 2, lq, lk, 16)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got = torch_attention._attend_chunked(*as_torch(q, k, v), **kw).numpy()
    ref = jax_chunked(q, k, v, q_chunk=q_chunk, **kw)
    np.testing.assert_allclose(got, np.asarray(ref), **F32_TOL)


def test_ops_dispatch_and_no_fallback():
    q, k, v = as_torch(*qkv(3, 1, 2, 1, 8, 8, 16))
    want = attention_ref(q, k, v, causal=True)
    for backend in ("auto", "torch"):
        torch.testing.assert_close(ops.attention(q, k, v, backend=backend),
                                   want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.attention(q, k, v, backend="pallas")
    # a CPU tensor given to the kernel raises; nothing falls back
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.attention(q, k, v, backend="cuda")
    assert flash_attention_cuda.launches == before


def test_rms_norm_rope_swiglu_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 7, 16), np.float32) * 3
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jax_layers.rms_norm(x, scale)), **LAYER_TOL)
    np.testing.assert_allclose(layers.rope_freqs(16, 10_000.0).numpy(),
                               np.asarray(jax_layers.rope_freqs(16, 10_000.0)),
                               **LAYER_TOL)
    # positions (L,) and per-slot positions (B, 1, 1) against x (B, H, 1, hd)
    pos = np.arange(7, dtype=np.int32) + 5
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0).numpy(),
        np.asarray(jax_layers.apply_rope(x, pos, 10_000.0)), **LAYER_TOL)
    slot_pos = np.array([3, 4000], np.int32)[:, None, None]
    x1 = x[:, :, :1]
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x1), torch.from_numpy(slot_pos),
                          10_000.0).numpy(),
        np.asarray(jax_layers.apply_rope(x1, slot_pos, 10_000.0)), **LAYER_TOL)
    params = {"w_in": rng.standard_normal((16, 2 * 24), np.float32) * 0.25,
              "w_out": rng.standard_normal((24, 16), np.float32) * 0.2}
    np.testing.assert_allclose(
        layers.swiglu_apply({n: torch.from_numpy(w) for n, w in params.items()},
                            torch.from_numpy(x)).numpy(),
        np.asarray(jax_layers.swiglu_apply(params, x)), rtol=1e-5, atol=1e-5)
