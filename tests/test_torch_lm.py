"""The port's LM serving path against the JAX package, on the CPU.

`gqa_apply` in every branch (no cache; full-cache prefill, scalar decode
and per-slot decode; ring prefill, decode and per-slot decode past a wrap
of the ring; a sliding window over a cache shorter than the window), the
LM's forward, prefill and decode, and `ServeEngine` on the requests of
tests/test_serving.py, for the reduced yi-6b and h2o-danube-1.8b; the
forward, prefill and decode of the qk-norm models gemma3-27b and
chameleon-34b (their norm scales moved off 0); every registry arch built
in the JAX package's tree. The JAX
params are carried across with `lm.params_from_numpy`; other inputs are
numpy draws from a seed. Floats must match to rtol/atol 1e-5 (both sides
compute in f32 at these configs), tokens exactly; in bf16, the engine's
cast copy of the params gives the numbers of the params as given. Then the JAX package's
own invariants, on the port alone, and the port's device contract.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import lm as jax_lm
from repro.serving import engine as jax_engine
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve
from repro_torch.models import attention, lm
from repro_torch.serving.engine import Request, ServeEngine


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
ARCHS = ("yi-6b", "h2o-danube-1.8b")
#: the dense models with qk-norm: gemma3's ("swa", "swa", "full") segment,
#: chameleon's untied LM head
QK_NORM_ARCHS = ("gemma3-27b", "chameleon-34b")

jax_gqa = jax.jit(jax_attention.gqa_apply, static_argnums=(1,),
                  static_argnames=("window",))
jax_forward = jax.jit(jax_lm.forward, static_argnums=(0,))
jax_prefill = jax.jit(jax_lm.prefill, static_argnums=(0, 3))
jax_decode = jax.jit(jax_lm.decode_step, static_argnums=(0,))
jax_logits = jax.jit(jax_lm.logits_for, static_argnums=(0,))
jax_init = jax.jit(jax_lm.init_params, static_argnums=(0,))


@functools.lru_cache(maxsize=None)
def jax_setup(arch):
    """(JAX cfg, the JAX package's init params); QK_NORM_ARCHS' norm scales
    (0 at init) moved by 0.1 · normal, so that the (1 + scale) paths count."""
    cfg = jax_get_config(arch, reduced=True)
    params = jax_init(cfg, jax.random.PRNGKey(0))
    if arch in QK_NORM_ARCHS:
        rng = np.random.default_rng(1)
        params = jax.tree_util.tree_map_with_path(
            lambda path, a: a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
            if path[-1].key in NORM_SCALES else a, params)
    return cfg, params


def setup(arch):
    """(JAX cfg, JAX params, port cfg, the same params as CPU tensors)."""
    cfg, params = jax_setup(arch)
    return (cfg, params, get_config(arch, reduced=True),
            lm.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))


def close(got, want, what):
    """Every leaf of `got` (tensors) against `want` (JAX), in tree order."""
    want, got = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(want) == len(got), what
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=what, **TOL)


def test_configs_are_copies():
    for arch in ARCH_IDS:
        for reduced in (False, True):
            assert (dataclasses.asdict(get_config(arch, reduced))
                    == dataclasses.asdict(jax_get_config(arch, reduced)))
    yi = get_config("yi-6b")
    assert (yi.num_layers, yi.d_model, yi.num_heads, yi.num_kv_heads, yi.hd,
            yi.d_ff, yi.vocab_size) == (32, 4096, 32, 4, 128, 11008, 64000)
    assert round(yi.param_count() / 1e9, 2) == 6.06


# (window of the block, max_seq, prefill length, scalar decode positions,
#  per-slot decode positions)
SCENARIOS = {
    "full": (0, 16, 7, (7, 8), ((9, 11), (10, 12))),
    # ring: s_max == window == 8; the 11-token prefill wraps the ring, the
    # decodes wrap it again
    "ring": (8, 32, 11, (11, 12), ((13, 17), (14, 22))),
    # a window over a cache shorter than it: not a ring
    "swa_short_cache": (8, 6, 4, (4,), ((5, 5),)),
}


@pytest.mark.parametrize("arch,scenario", [("yi-6b", "full"),
                                           ("h2o-danube-1.8b", "ring"),
                                           ("h2o-danube-1.8b", "swa_short_cache")])
def test_gqa_apply_every_branch_matches_jax(arch, scenario):
    jcfg, jparams, cfg, params = setup(arch)
    window, max_seq, l, scalar_pos, slot_pos = SCENARIOS[scenario]
    assert window == cfg.window
    take = lambda tree: jax.tree.map(lambda x: x[0], tree["segments"][0]["b0"]["attn"])
    jp = take(jparams)
    p = {k: v[0] for k, v in params["segments"][0]["b0"]["attn"].items()}
    rng = np.random.default_rng(l)
    x = rng.standard_normal((2, l + 2, cfg.d_model), np.float32)

    # no cache: the whole sequence
    want, _ = jax_gqa(jp, jcfg, x, window=window)
    got, _ = attention.gqa_apply(p, cfg, torch.from_numpy(x), window=window)
    close(got, want, "no cache")

    jcache = jax_attention.gqa_cache_init(jcfg, 2, max_seq, window, jnp.float32)
    cache = attention.gqa_cache_init(cfg, 2, max_seq, window, torch.float32)
    assert cache.k.shape == jcache.k.shape
    steps = [(x[:, :l], 0)]
    steps += [(rng.standard_normal((2, 1, cfg.d_model), np.float32), pos)
              for pos in scalar_pos]
    steps += [(rng.standard_normal((2, 1, cfg.d_model), np.float32),
               np.asarray(pos, np.int32)) for pos in slot_pos]
    for xs, pos in steps:
        want, jcache = jax_gqa(jp, jcfg, xs, window=window, cache=jcache,
                               cache_pos=jnp.asarray(pos))
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        got, cache = attention.gqa_apply(p, cfg, torch.from_numpy(xs),
                                         window=window, cache=cache,
                                         cache_pos=tpos)
        close(got, want, f"{scenario} output at cache_pos {pos}")
        close(cache, jcache, f"{scenario} cache after cache_pos {pos}")


@pytest.mark.parametrize("arch", ARCHS + QK_NORM_ARCHS)
def test_forward_prefill_decode_match_jax(arch):
    jcfg, jparams, cfg, params = setup(arch)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    want, _ = jax_forward(jcfg, jparams, {"tokens": tokens})
    got, _ = lm.forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    close(got, want, "forward hidden")
    close(lm.logits_for(cfg, params, got), jax_logits(jcfg, jparams, want),
          "forward logits")

    max_seq = 24
    want, jcaches = jax_prefill(jcfg, jparams, {"tokens": tokens[:, :11]}, max_seq)
    got, caches = lm.prefill(cfg, params, {"tokens": torch.from_numpy(tokens[:, :11])},
                             max_seq)
    close(got, want, "prefill logits")
    close(caches, jcaches, "prefill caches")
    for pos in (11, np.asarray([12, 14], np.int32)):
        tok = tokens[:, 11:12] if not isinstance(pos, np.ndarray) else tokens[:, 12:13]
        want, jcaches = jax_decode(jcfg, jparams, jcaches, tok, jnp.asarray(pos))
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        got, caches = lm.decode_step(cfg, params, caches, torch.from_numpy(tok), tpos)
        close(got, want, f"decode logits at {pos}")
        close(caches, jcaches, f"decode caches at {pos}")


def test_engine_serves_the_jax_engines_tokens(monkeypatch):
    """tests/test_serving.py::test_engine_serves_all_requests's requests,
    through both engines: every token equal, and the same stats keys."""
    jcfg, jparams, cfg, params = setup("yi-6b")
    # the JAX engine prefills eagerly; jit it (the same function) for speed
    monkeypatch.setattr(jax_engine.lm, "prefill", jax_prefill)

    def requests(cls):
        rng = np.random.default_rng(0)
        return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size, 4 + i),
                    max_new_tokens=6) for i in range(7)]

    jeng = jax_engine.ServeEngine(jcfg, jparams, slots=3, max_seq=64)
    jreqs = requests(jax_engine.Request)
    eng = ServeEngine(cfg, params, slots=3, max_seq=64, device="cpu")
    reqs = requests(Request)
    for e, rs in ((jeng, jreqs), (eng, reqs)):
        for r in rs:
            e.submit(r)
        e.run(max_ticks=300)
    for r, jr in zip(reqs, jreqs):
        assert len(r.output) == 6
        assert r.output == jr.output, r.rid
    assert eng.stats().keys() == jeng.stats().keys()
    assert eng.stats()["released"] == 7


#: bf16 logits against JAX's, as a vector: ||got - want|| <= 5e-2 ||want||,
#: the JAX package's bf16 tolerance (tests/test_kernels.py::
#: test_flash_attention_bf16) on the whole logit vector. Elementwise it is
#: too tight: the two frameworks' bf16 products round differently, and the
#: layers carry those roundings to every logit (0.058 on one logit near 0
#: of 512 in the danube decode; the vector's error is 0.013 of its norm).
BF16_LOGIT_REL = 5e-2
NORM_SCALES = ("ln1", "ln2", "final_scale", "q_scale", "k_scale")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_params_keep_the_numbers_in_bf16(arch):
    """In bf16, with non-zero norm scales carried across from JAX: the
    engine's copy (matrices cast once, `lm.compute_params`) keeps the norm
    scales in f32 and gives the prefill and per-slot decode logits of the
    params as given, bit for bit; both agree with the JAX package's bf16
    prefill and decode within BF16_LOGIT_REL."""
    jcfg, jparams, cfg, _ = setup(arch)
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    rng = np.random.default_rng(3)

    def scales(path, a):
        if getattr(path[-1], "key", None) in NORM_SCALES:
            return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(scales, jax.tree.map(np.asarray, jparams))
    jparams = jax.tree.map(jnp.asarray, tree)
    params = lm.params_from_numpy(tree, "cpu")
    eng = ServeEngine(cfg, params, slots=1, max_seq=32, device="cpu")
    for path, x in jax.tree_util.tree_leaves_with_path(eng.params):
        key = path[-1].key
        assert x.dtype == (torch.float32 if key in NORM_SCALES else torch.bfloat16), key

    tokens = rng.integers(0, cfg.vocab_size, (1, 9)).astype(np.int32)
    pos = np.asarray([8], np.int32)
    want, jcaches = jax_prefill(jcfg, jparams, {"tokens": tokens[:, :8]}, 32)
    want_step, _ = jax_decode(jcfg, jparams, jcaches, tokens[:, 8:], jnp.asarray(pos))
    for p in (params, eng.params):
        got, caches = lm.prefill(cfg, p, {"tokens": torch.from_numpy(tokens[:, :8])}, 32)
        step, _ = lm.decode_step(cfg, p, caches, torch.from_numpy(tokens[:, 8:]),
                                 torch.from_numpy(pos))
        if p is params:
            exact = got, step
        else:
            torch.testing.assert_close((got, step), exact, rtol=0, atol=0)
        for a, b in ((got, want), (step, want_step)):
            b = np.asarray(b, np.float32)
            assert np.linalg.norm(a.numpy() - b) <= BF16_LOGIT_REL * np.linalg.norm(b)


# -- the JAX package's invariants, on the port ---------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """tests/test_models.py::test_decode_matches_forward on the port."""
    _, _, cfg, params = setup(arch)
    rng = np.random.default_rng(0)
    b, l = 2, 12
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, l + 1)))
    hidden, _ = lm.forward(cfg, params, {"tokens": tokens})
    ref = lm.logits_for(cfg, params, hidden[:, -1:])[:, 0]
    _, caches = lm.prefill(cfg, params, {"tokens": tokens[:, :l]}, max_seq=l + 4)
    logits, _ = lm.decode_step(cfg, params, caches, tokens[:, l:l + 1], l)
    torch.testing.assert_close(logits, ref, rtol=2e-3, atol=2e-3)


def test_swa_sees_only_window():
    """tests/test_models.py::test_swa_sees_only_window on the port."""
    cfg = ModelConfig(name="w", family="dense", d_model=32, num_heads=2, num_kv_heads=2,
                      d_ff=64, vocab_size=64, segments=((("swa",), 1),), window=4,
                      dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (1, 10)))
    toks2 = toks.clone()
    toks2[0, 0] = (toks[0, 0] + 1) % 64
    h1, _ = lm.forward(cfg, params, {"tokens": toks})
    h2, _ = lm.forward(cfg, params, {"tokens": toks2})
    torch.testing.assert_close(h1[:, -1], h2[:, -1], rtol=0, atol=1e-5)
    assert not torch.allclose(h1[:, 1], h2[:, 1], atol=1e-5)


def test_engine_matches_sequential_decode():
    """tests/test_serving.py::test_engine_matches_sequential_decode on the
    port."""
    _, _, cfg, params = setup("yi-6b")
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, 6)
    eng = ServeEngine(cfg, params, slots=2, max_seq=64, device="cpu")
    target = Request(rid=0, prompt=prompt, max_new_tokens=5)
    other = Request(rid=1, prompt=rng.integers(0, cfg.vocab_size, 9), max_new_tokens=5)
    eng.submit(target)
    eng.submit(other)
    eng.run(max_ticks=100)

    logits, caches = lm.prefill(cfg, params, {"tokens": torch.from_numpy(prompt)[None]},
                                max_seq=64)
    toks = [int(torch.argmax(logits[:, -1], -1)[0])]
    for pos in range(len(prompt), len(prompt) + 4):
        lgt, caches = lm.decode_step(cfg, params, caches, torch.tensor([[toks[-1]]]), pos)
        toks.append(int(torch.argmax(lgt[0])))
    assert target.output[:5] == toks[:5]


# -- the device contract --------------------------------------------------------

def test_init_params_has_the_jax_tree_and_distributions():
    jcfg, jparams, cfg, _ = setup("yi-6b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda tree: [tuple(x.shape) for x in jax.tree.leaves(tree)]
    assert shapes(params) == shapes(jparams)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, params)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, jparams))
    attn = params["segments"][0]["b0"]["attn"]
    for w, fan_in in ((attn["wq"], cfg.d_model), (attn["wo"], cfg.num_heads * cfg.hd),
                      (params["embed"], cfg.d_model)):
        assert w.dtype == torch.float32
        assert abs(float(w.std()) * fan_in ** 0.5 - 1) < 0.1
    assert not params["final_scale"].any()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_unported_block_kinds_raise(arch):
    """Every block kind of the JAX package is ported: each registry arch's
    reduced config builds on the CPU in the JAX package's tree (structure
    and shapes); a kind neither package knows raises ValueError in both."""
    jcfg, cfg = jax_get_config(arch, reduced=True), get_config(arch, reduced=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jparams = jax.eval_shape(lambda: jax_lm.init_params(jcfg, jax.random.PRNGKey(0)))
    assert jax.tree.structure(jax.tree.map(lambda _: 0, params)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, jparams))
    assert [tuple(x.shape) for x in jax.tree.leaves(params)] == \
        [x.shape for x in jax.tree.leaves(jparams)]
    unknown = ((("conv",), 1),)
    with pytest.raises(ValueError, match="unknown block kind 'conv'"):
        lm.init_params(dataclasses.replace(cfg, segments=cfg.segments + unknown),
                       torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="unknown block kind 'conv'"):
        jax.eval_shape(lambda: jax_lm.init_params(
            dataclasses.replace(jcfg, segments=jcfg.segments + unknown),
            jax.random.PRNGKey(0)))


def test_entry_points_need_a_card_unless_given_the_cpu(monkeypatch, capsys):
    _, _, cfg, params = setup("yi-6b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params)
    argv = ["--requests", "3", "--slots", "2", "--max-new", "4"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(argv)
    reqs = serve.main(argv + ["--device", "cpu"])
    assert [len(r.output) for r in reqs] == [4, 4, 4]
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out
    eng = ServeEngine(cfg, params, device="cpu")
    assert eng.device == torch.device("cpu")
