"""The port's MLA path against the JAX package, on the CPU.

`mla_apply` in its naive and absorbed forms (no cache; a prefill into a
cache, scalar decodes, a decode past the cache's end that the write
clamps), its refusal of per-slot positions; the attention core with a
value head dim of its own and a `scale` against JAX's `_attend_chunked`,
and the kernel's refusal of the dims it is not built for; the LM's forward,
prefill and decode for the reduced minicpm3-4b and `init_params`' tree;
both engines' refusal of an MLA model. The params are numpy draws in the
JAX package's tree, carried across with `lm.params_from_numpy`; other
inputs are numpy draws from a seed. Floats must match to rtol/atol 1e-5 (both sides compute in f32 at the
reduced config), 3e-5 for the attention core (tests/test_kernels.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import lm as jax_lm
from repro.serving import engine as jax_engine
from repro_torch.configs.registry import get_config
from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention.flash import HEAD_DIMS, flash_attention_cuda
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.launch import serve
from repro_torch.models import attention, lm
from repro_torch.serving.engine import ServeEngine


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_TOL = dict(rtol=3e-5, atol=3e-5)     # tests/test_kernels.py
ARCH = "minicpm3-4b"

jax_mla = jax.jit(jax_attention.mla_apply, static_argnums=(1,))
jax_chunked = jax.jit(jax_attention._attend_chunked,
                      static_argnames=("causal", "window", "q_offset", "q_chunk",
                                       "scale"))
jax_forward = jax.jit(jax_lm.forward, static_argnums=(0,))
jax_prefill = jax.jit(jax_lm.prefill, static_argnums=(0, 3))
jax_decode = jax.jit(jax_lm.decode_step, static_argnums=(0,))
jax_logits = jax.jit(jax_lm.logits_for, static_argnums=(0,))


#: norm scales: drawn as 0.1 · normal, so the (1 + scale) path counts
NORM_SCALES = ("ln1", "ln2", "final_scale", "q_scale", "k_scale", "kv_scale")


@functools.lru_cache(maxsize=None)
def jax_setup(arch):
    """(JAX cfg, numpy params in the JAX package's tree). The tree and its
    shapes come from `jax.eval_shape` of `init_params` (no compile); the
    values are numpy draws: matrices normal / sqrt(fan-in), norm scales
    0.1 · normal."""
    cfg = jax_get_config(arch, reduced=True)
    shapes = jax.eval_shape(lambda: jax_lm.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        key = path[-1].key
        if key in NORM_SCALES:
            return 0.1 * x
        return x / np.sqrt(leaf.shape[-1 if key == "embed" else -2])

    return cfg, jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def setup():
    """(JAX cfg, JAX params, port cfg, the same params as CPU tensors)."""
    cfg, params = jax_setup(ARCH)
    return (cfg, jax.tree.map(jnp.asarray, params), get_config(ARCH, reduced=True),
            lm.params_from_numpy(params, "cpu"))


def close(got, want, what, tol=TOL):
    """Every leaf of `got` (tensors) against `want` (JAX), in tree order."""
    want, got = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(want) == len(got), what
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=what, **tol)


def layer0(tree):
    """Layer 0 of the first block's attention params."""
    return tree["segments"][0]["b0"]["attn"]


# (prefill length, scalar decode positions): the last decode sits past the
# 16-slot cache's end, so both writes clamp to its last slot
MAX_SEQ, PREFILL, DECODES = 16, 9, (9, 10, 19)


@pytest.mark.parametrize("absorb", [False, True], ids=["naive", "absorbed"])
def test_mla_apply_matches_jax(setup, absorb):
    jcfg, jparams, cfg, params = setup
    jcfg = dataclasses.replace(jcfg, mla_absorb=absorb)
    cfg = dataclasses.replace(cfg, mla_absorb=absorb)
    jp = jax.tree.map(lambda x: x[0], layer0(jparams))
    p = {k: v[0] for k, v in layer0(params).items()}
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, PREFILL + 3, cfg.d_model), np.float32)

    # no cache: the whole sequence
    want, _ = jax_mla(jp, jcfg, x)
    got, cache = attention.mla_apply(p, cfg, torch.from_numpy(x))
    assert cache is None
    close(got, want, "no cache")

    jcache = jax_attention.mla_cache_init(jcfg, 2, MAX_SEQ, jnp.float32)
    cache = attention.mla_cache_init(cfg, 2, MAX_SEQ, torch.float32)
    assert [c.shape for c in cache] == [c.shape for c in jcache]
    steps = [(x[:, :PREFILL], 0)] + [
        (rng.standard_normal((2, 1, cfg.d_model), np.float32), pos)
        for pos in DECODES]
    for xs, pos in steps:
        l = xs.shape[1]
        positions = np.arange(pos, pos + l)
        want, jcache = jax_mla(jp, jcfg, xs, positions=positions, cache=jcache,
                               cache_pos=jnp.asarray(pos))
        got, cache = attention.mla_apply(p, cfg, torch.from_numpy(xs),
                                         positions=torch.from_numpy(positions),
                                         cache=cache, cache_pos=pos)
        close(got, want, f"output at cache_pos {pos}")
        close(cache, jcache, f"cache after cache_pos {pos}")


def test_mla_apply_refuses_per_slot_positions(setup):
    _, _, cfg, params = setup
    p = {k: v[0] for k, v in layer0(params).items()}
    cache = attention.mla_cache_init(cfg, 2, MAX_SEQ, torch.float32)
    x = torch.zeros((2, 1, cfg.d_model))
    with pytest.raises(NotImplementedError, match="attention.py:278"):
        attention.mla_apply(p, cfg, x, cache=cache,
                            cache_pos=torch.tensor([3, 5]))
    assert not cache.c_kv.any() and not cache.k_rope.any()


@pytest.mark.parametrize("hq,hkv,lq,lk,d,dv,q_offset,scale", [
    (4, 4, 12, 12, 24, 16, 0, 24 ** -0.5),      # the reduced MLA's naive form
    (4, 4, 1, 20, 96, 64, 13, 96 ** -0.5),      # MiniCPM3's heads, decode
    (4, 1, 6, 20, 24, 16, 5, 0.3),              # absorbed: one KV head
    (8, 2, 7, 7, 32, 48, 0, None),              # Dv > D, the default scale
])
def test_attention_with_its_own_value_dim_matches_jax(hq, hkv, lq, lk, d, dv,
                                                      q_offset, scale):
    rng = np.random.default_rng(lq * 100 + lk + dv)
    q = rng.standard_normal((2, hq, lq, d), np.float32)
    k = rng.standard_normal((2, hkv, lk, d), np.float32)
    v = rng.standard_normal((2, hkv, lk, dv), np.float32)
    kw = dict(causal=True, q_offset=q_offset, scale=scale)
    want = np.asarray(jax_chunked(q, k, v, window=0, **kw))
    assert want.shape == (2, hq, lq, dv)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for got in (attention_ref(tq, tk, tv, **kw), ops.attention(tq, tk, tv, **kw),
                attention._attend_chunked(tq, tk, tv, **kw)):
        np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


def test_kernel_refuses_the_absorbed_dims():
    """The kernel is built for MLA's absorbed form: at MiniCPM3's widths it
    attends with (288, 256) over one KV head. Given CPU tensors of those
    dims, the wrapper refuses them for their device (not for their dims),
    as it does the naive form's (96, 64), and launches nothing; a pair that
    is neither built nor paddable (above 128) is still refused for its
    dims."""
    cfg = get_config(ARCH)
    d = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    assert (d, cfg.kv_lora_rank) == (288, 256) and (288, 256) in HEAD_DIMS
    q = torch.zeros((1, cfg.num_heads, 4, d))
    k = torch.zeros((1, 1, 8, d))
    v = torch.zeros((1, 1, 8, cfg.kv_lora_rank))
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.attention(q, k, v, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, k, v)
    # the naive form's dims are built too
    q = torch.zeros((1, 4, 4, 96))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, torch.zeros((1, 4, 8, 96)), torch.zeros((1, 4, 8, 64)))
    with pytest.raises(NotImplementedError, match=r"\(160, 128\)"):
        flash_attention_cuda(torch.zeros((1, 4, 4, 160)), torch.zeros((1, 4, 8, 160)),
                             torch.zeros((1, 4, 8, 128)))
    assert flash_attention_cuda.launches == before


@pytest.mark.parametrize("d,dv,pair", [
    (24, 16, (32, 32)),       # the reduced MiniCPM3's MLA heads
    (48, 48, (64, 64)),
    (72, 64, (80, 80)),
    (96, 64, None),           # built: no padding
    (144, 128, None),         # above the pad limit: refused on the card
])
def test_padded_plain_path_equals_the_unpadded_one(d, dv, pair):
    """ops pads an unbuilt pair with both dims <= 128 to the least built
    pair covering it; the padded plain attention (the function the kernel
    computes on the card) equals the unpadded one."""
    assert ops.padded_pair(d, dv) == pair
    if pair is None:
        return
    rng = np.random.default_rng(d + dv)
    q = torch.from_numpy(rng.standard_normal((2, 4, 7, d), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 2, 11, d), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 2, 11, dv), np.float32))
    for kw in (dict(causal=True, q_offset=4), dict(causal=True, window=3),
               dict(causal=False, scale=0.3)):
        want = attention_ref(q, k, v, **kw)
        got = ops.padded(attention_ref, q, k, v, pair, **kw)
        assert got.shape == want.shape and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("absorb", [False, True], ids=["naive", "absorbed"])
def test_forward_prefill_decode_match_jax(setup, absorb):
    jcfg, jparams, cfg, params = setup
    jcfg = dataclasses.replace(jcfg, mla_absorb=absorb)
    cfg = dataclasses.replace(cfg, mla_absorb=absorb)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    want, jaux = jax_forward(jcfg, jparams, {"tokens": tokens})
    got, aux = lm.forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    close(got, want, "forward hidden")
    close(aux, jaux, "forward aux")
    close(lm.logits_for(cfg, params, got), jax_logits(jcfg, jparams, want),
          "forward logits")

    max_seq = 24
    want, jcaches = jax_prefill(jcfg, jparams, {"tokens": tokens[:, :11]}, max_seq)
    got, caches = lm.prefill(cfg, params, {"tokens": torch.from_numpy(tokens[:, :11])},
                             max_seq)
    close(got, want, "prefill logits")
    close(caches, jcaches, "prefill caches")
    for pos in (11, 12):
        tok = tokens[:, pos:pos + 1]
        want, jcaches = jax_decode(jcfg, jparams, jcaches, tok, pos)
        got, caches = lm.decode_step(cfg, params, caches, torch.from_numpy(tok), pos)
        close(got, want, f"decode logits at {pos}")
        close(caches, jcaches, f"decode caches at {pos}")


def test_decode_matches_forward(setup):
    """tests/test_models.py::test_decode_matches_forward on the port."""
    _, _, cfg, params = setup
    rng = np.random.default_rng(0)
    b, l = 2, 12
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, l + 1)))
    hidden, _ = lm.forward(cfg, params, {"tokens": tokens})
    ref = lm.logits_for(cfg, params, hidden[:, -1:])[:, 0]
    _, caches = lm.prefill(cfg, params, {"tokens": tokens[:, :l]}, max_seq=l + 4)
    logits, _ = lm.decode_step(cfg, params, caches, tokens[:, l:l + 1], l)
    torch.testing.assert_close(logits, ref, rtol=2e-3, atol=2e-3)


def test_init_params_has_the_jax_tree_and_distributions(setup):
    _, jparams, cfg, _ = setup
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda tree: [tuple(x.shape) for x in jax.tree.leaves(tree)]
    assert shapes(params) == shapes(jparams)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, params)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, jparams))
    big = get_config(ARCH)
    attn = lm.init_params(
        dataclasses.replace(big, segments=((("mla",), 1),), vocab_size=8),
        torch.Generator().manual_seed(1), "cpu")["segments"][0]["b0"]["attn"]
    hq, vd = big.num_heads, big.v_head_dim
    for key, fan_in in (("w_dq", big.d_model), ("w_uq", big.q_lora_rank),
                        ("w_dkv", big.d_model), ("w_ukv", big.kv_lora_rank),
                        ("wo", hq * vd)):
        assert attn[key].dtype == torch.float32
        assert abs(float(attn[key].std()) * fan_in ** 0.5 - 1) < 0.02, key
    assert not attn["q_scale"].any() and not attn["kv_scale"].any()
    assert lm.MATRICES >= {"w_dq", "w_uq", "w_dkv", "w_ukv"}


def test_both_engines_refuse_an_mla_model(setup, monkeypatch):
    """The JAX engine's decode passes per-slot positions (slots,), which
    mla_apply's dynamic_update_slice cannot take; the port's engine and
    launcher refuse the model with a named error instead."""
    jcfg, jparams, cfg, params = setup
    jeng = jax_engine.ServeEngine(jcfg, jparams, slots=2, max_seq=16)
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        jeng._decode(jeng.params, jeng.state)
    with pytest.raises(NotImplementedError, match="scalar cache position"):
        ServeEngine(cfg, params, slots=2, max_seq=16, device="cpu")
    monkeypatch.setattr(lm, "init_params", lambda *a: pytest.fail("drew params"))
    with pytest.raises(NotImplementedError, match="lm.decode_step"):
        serve.main(["--arch", ARCH, "--device", "cpu"])
