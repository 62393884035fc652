"""The plain attention's log-sum-exp output and the merge of key ranges
(kernels/attention/ref.py, ops.merge) on the CPU.

- `attention_ref(..., return_lse=True)` gives, per query row, the
  log-sum-exp of its visible scaled scores: held against a direct
  `torch.logsumexp` of the masked scores at 1e-6, causal, windowed, at a
  `q_offset` (a negative one leaves rows that see no key: lse -inf, output
  0); its output is the output without lse bit for bit, and the JAX
  package's `attention_ref` on the same numpy inputs at 1e-5.
- `ops.merge` of the (output, lse) pairs of attention over disjoint key
  ranges (each with `q_offset` shifted by its first key, as a rank of a
  sequence-split cache runs it) is attention over all the keys, at 1e-6,
  also where a range holds no key a row can see; the zero-padded pair
  (`ops.padded`) keeps the unpadded lse.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention.ref import attention_ref


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(rtol=1e-6, atol=1e-6)
#: (causal, window, q_offset): causal, windowed, a decode-like offset, a
#: negative one (the first rows see no key), not causal
MASKS = [(True, 0, 0), (True, 5, 3), (True, 0, 9), (True, 3, -4),
         (False, 0, 0)]


def _inputs(b=2, hq=4, hkv=2, lq=7, lk=16, d=16, dv=16, seed=0):
    rng = np.random.default_rng(seed)
    draw = lambda *s: rng.standard_normal(s).astype(np.float32)
    return draw(b, hq, lq, d), draw(b, hkv, lk, d), draw(b, hkv, lk, dv)


def _direct_lse(q, k, causal, window, q_offset):
    """logsumexp of the visible scaled scores, -inf where none is."""
    group = q.shape[1] // k.shape[1]
    s = q @ k.repeat_interleave(group, 1).transpose(-1, -2) * q.shape[-1] ** -0.5
    qpos = torch.arange(q.shape[2])[:, None] + q_offset
    kpos = torch.arange(k.shape[2])[None, :]
    mask = torch.ones_like(s[0, 0], dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return torch.logsumexp(s.masked_fill(~mask, float("-inf")), -1)


@pytest.mark.parametrize("causal,window,q_offset", MASKS)
def test_plain_lse_is_the_logsumexp_of_the_visible_scores(causal, window,
                                                          q_offset):
    import jax.numpy as jnp

    from repro.kernels.attention.ref import attention_ref as jax_ref

    q, k, v = _inputs()
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = attention_ref(tq, tk, tv, return_lse=True, **kw)
    torch.testing.assert_close(lse, _direct_lse(tq, tk, **kw), **TOL)
    assert torch.equal(out, attention_ref(tq, tk, tv, **kw))
    blind = torch.isinf(lse)
    assert bool(blind.any()) == (q_offset < 0)
    assert torch.equal(out[blind], torch.zeros_like(out[blind]))
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              **kw))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,window,q_offset", MASKS)
@pytest.mark.parametrize("cuts", [(8,), (3, 11), (5, 6, 15)])
def test_merge_of_key_ranges_is_attention_over_all_keys(causal, window,
                                                        q_offset, cuts):
    q, k, v = (torch.from_numpy(x) for x in _inputs(seed=1))
    kw = dict(causal=causal, window=window)
    whole = attention_ref(q, k, v, q_offset=q_offset, **kw)
    edges = (0,) + cuts + (k.shape[2],)
    parts = [attention_ref(q, k[:, :, a:b], v[:, :, a:b], return_lse=True,
                           q_offset=q_offset - a, **kw)
             for a, b in zip(edges, edges[1:])]
    merged = ops.merge(torch.stack([o for o, _ in parts]),
                       torch.stack([lse for _, lse in parts]))
    torch.testing.assert_close(merged, whole, **TOL)


def test_padded_pair_keeps_the_lse():
    q, k, v = (torch.from_numpy(x) for x in _inputs(d=24, dv=16, seed=2))
    out, lse = ops.padded(attention_ref, q, k, v, (32, 32), return_lse=True,
                          q_offset=4)
    want, want_lse = attention_ref(q, k, v, return_lse=True, q_offset=4)
    torch.testing.assert_close(out, want, **TOL)
    torch.testing.assert_close(lse, want_lse, **TOL)
