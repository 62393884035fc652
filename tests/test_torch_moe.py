"""The port's MoE path against the JAX package, on the CPU.

`moe_apply`'s output and load-balance loss with capacity drops, with
grouped dispatch (2 groups, and 3, which does not divide the tokens and
falls back to 2), and with exact router ties (duplicated router columns,
integer-valued logits): the expert ids exact; `moe_ref` against JAX's; the
LM's forward, prefill and decode for the reduced olmoe-1b-7b and
granite-moe-1b-a400m and `init_params`' tree; `ServeEngine` on the
requests of tests/test_serving.py, every token equal to the JAX engine's.
The params are numpy draws in the JAX package's tree, carried across with
`lm.params_from_numpy`; other inputs are numpy draws from a seed. Floats must match to rtol/atol 1e-5
(both sides compute in f32 at the reduced configs), ids and tokens exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import lm as jax_lm
from repro.models import moe as jax_moe
from repro.serving import engine as jax_engine
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve
from repro_torch.models import lm, moe
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
ARCHS = ("olmoe-1b-7b", "granite-moe-1b-a400m")

jax_moe_apply = jax.jit(jax_moe.moe_apply, static_argnums=(1,))
jax_moe_ref = jax.jit(jax_moe.moe_ref, static_argnums=(1,))
jax_top_k = jax.jit(jax.lax.top_k, static_argnums=(1,))
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


def setup(arch):
    """(JAX cfg, JAX params, port cfg, the same params as CPU tensors)."""
    cfg, params = jax_setup(arch)
    return (cfg, jax.tree.map(jnp.asarray, params), get_config(arch, reduced=True),
            lm.params_from_numpy(params, "cpu"))


def close(got, want, what):
    """Every leaf of `got` (tensors) against `want` (JAX), in tree order."""
    want, got = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(want) == len(got), what
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=what, **TOL)


def layer0_moe(arch):
    """(JAX cfg, JAX layer-0 MoE params, port cfg, the port's)."""
    jcfg, jparams, cfg, params = setup(arch)
    jp = jax.tree.map(lambda x: np.array(x[0]), jparams["segments"][0]["b0"]["moe"])
    return jcfg, jp, cfg, {k: torch.from_numpy(v) for k, v in jp.items()}


def max_load(cfg, params, x, groups):
    """The most entries any expert gets in any group (the port's routing)."""
    g = x.shape[0] * x.shape[1]
    g = next(n for n in range(max(groups, 1), 0, -1) if g % n == 0)
    logits = x.reshape(g, -1, x.shape[-1]) @ params["router"]
    _, idx = moe.top_k(logits, cfg.num_experts_per_tok)
    return max(int(torch.bincount(row.reshape(-1)).max()) for row in idx)


# (arch, capacity_factor or None for the config's, moe_groups, (B, L))
CASES = {
    "olmoe": ("olmoe-1b-7b", None, 0, (2, 13)),
    "granite": ("granite-moe-1b-a400m", None, 0, (2, 13)),
    "drops": ("olmoe-1b-7b", 0.5, 0, (2, 24)),
    "groups2": ("olmoe-1b-7b", None, 2, (2, 12)),
    "groups3_of_80": ("granite-moe-1b-a400m", 0.5, 3, (2, 40)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_jax(case):
    arch, factor, groups, (b, l) = CASES[case]
    jcfg, jp, cfg, p = layer0_moe(arch)
    over = dict(moe_groups=groups)
    if factor is not None:
        over["capacity_factor"] = factor
    jcfg, cfg = (dataclasses.replace(c, **over) for c in (jcfg, cfg))
    x = np.random.default_rng(b * l + groups).standard_normal(
        (b, l, cfg.d_model), np.float32)
    want, jaux = jax_moe_apply(jp, jcfg, x)
    got, aux = moe.moe_apply(p, cfg, torch.from_numpy(x))
    close(got, want, f"{case} output")
    close(aux, jaux, f"{case} aux")
    g = 2 if groups else 1
    cap = moe.moe_capacity(b * l // g, cfg)
    assert cap == jax_moe.moe_capacity(b * l // g, jcfg)
    if factor is not None:   # the case drops entries past the capacity
        assert max_load(cfg, p, torch.from_numpy(x), groups) > cap, case


def test_moe_router_ties_pick_the_jax_experts():
    """Duplicated router columns and integer-valued inputs make exact ties
    in both frameworks' logits; the expert ids must be JAX's (the lower
    index first), and so the outputs."""
    jcfg, jp, cfg, p = layer0_moe("olmoe-1b-7b")
    rng = np.random.default_rng(4)
    k = cfg.num_experts_per_tok
    router = rng.integers(-1, 2, (cfg.d_model, 3)).astype(np.float32)
    # the 8 experts' columns are 3 distinct ones, 3, 3 and 2 times over
    jp = dict(jp, router=np.repeat(router, [3, 3, 2], axis=1))
    p = dict(p, router=torch.from_numpy(jp["router"]))
    x = rng.integers(-2, 3, (2, 16, cfg.d_model)).astype(np.float32)
    logits = x.reshape(-1, cfg.d_model) @ jp["router"]
    ranked = np.sort(logits, axis=-1)[:, ::-1]
    assert (ranked[:, k - 1] == ranked[:, k]).mean() > 0.5   # ties at the cut
    want_vals, want_idx = jax_top_k(logits, k)
    vals, idx = moe.top_k(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))
    want, jaux = jax_moe_apply(jp, jcfg, x)
    got, aux = moe.moe_apply(p, cfg, torch.from_numpy(x))
    close(got, want, "tied output")
    close(aux, jaux, "tied aux")


def test_moe_ref_matches_jax_and_moe_apply():
    jcfg, jp, cfg, p = layer0_moe("granite-moe-1b-a400m")
    x = np.random.default_rng(9).standard_normal((2, 5, cfg.d_model), np.float32)
    want = jax_moe_ref(jp, jcfg, x)
    got = moe.moe_ref(p, cfg, torch.from_numpy(x))
    close(got, want, "moe_ref")
    # the config's capacity drops nothing on 10 tokens: the two agree
    out, _ = moe.moe_apply(p, cfg, torch.from_numpy(x))
    torch.testing.assert_close(out, got, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch):
    jcfg, jparams, cfg, params = setup(arch)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    want, jaux = jax_forward(jcfg, jparams, {"tokens": tokens})
    got, aux = lm.forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    close(got, want, "forward hidden")
    close(aux, jaux, "forward aux")
    assert float(aux) > 0
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
        want, jcaches = jax_decode(jcfg, jparams, jcaches, tok, pos)
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        got, caches = lm.decode_step(cfg, params, caches, torch.from_numpy(tok), tpos)
        close(got, want, f"decode logits at {pos}")
        close(caches, jcaches, f"decode caches at {pos}")


def test_only_forward_computes_the_aux_loss(monkeypatch):
    """forward sums one aux loss a MoE layer; prefill and decode read none
    and compute none (moe_apply(aux=False) skips moe_aux)."""
    _, _, cfg, params = setup("olmoe-1b-7b")
    calls = []
    monkeypatch.setattr(moe, "moe_aux",
                        lambda *a: calls.append(1) or torch.zeros(()))
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 6)))
    lm.forward(cfg, params, {"tokens": tokens})
    assert len(calls) == cfg.num_layers
    calls.clear()
    logits, caches = lm.prefill(cfg, params, {"tokens": tokens[:, :5]}, 8)
    lm.decode_step(cfg, params, caches, tokens[:, 5:], 5)
    lm.decode_step(cfg, params, caches, tokens[:, 5:], torch.tensor([6, 7]))
    assert calls == []
    layer0 = {k: v[0] for k, v in params["segments"][0]["b0"]["moe"].items()}
    out, aux = moe.moe_apply(layer0, cfg, torch.zeros((1, 3, cfg.d_model)),
                             aux=False)
    assert aux is None and out.shape == (1, 3, cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_jax_tree_and_distributions(arch):
    _, jparams, cfg, _ = setup(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda tree: [tuple(x.shape) for x in jax.tree.leaves(tree)]
    assert shapes(params) == shapes(jparams)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, params)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, jparams))
    p = params["segments"][0]["b0"]["moe"]
    for key, fan_in in (("router", cfg.d_model), ("w_in", cfg.d_model),
                        ("w_out", cfg.d_ff)):
        assert p[key].dtype == torch.float32
        assert abs(float(p[key].std()) * fan_in ** 0.5 - 1) < 0.1, key
    assert "router" in lm.MATRICES


def all_requests(cls, vocab):
    """tests/test_serving.py::test_engine_serves_all_requests's requests:
    7 prompts of 4 to 10 tokens, 6 new tokens each, over 3 slots."""
    rng = np.random.default_rng(0)
    return 3, [cls(rid=i, prompt=rng.integers(0, vocab, 4 + i),
                   max_new_tokens=6) for i in range(7)]


def sequential_requests(cls, vocab):
    """tests/test_serving.py::test_engine_matches_sequential_decode's two
    requests (6 and 9 prompt tokens, 5 new tokens each) over 2 slots."""
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, vocab, 6)
    return 2, [cls(rid=0, prompt=prompt, max_new_tokens=5),
               cls(rid=1, prompt=rng.integers(0, vocab, 9), max_new_tokens=5)]


# the JAX engine compiles a prefill per prompt length: the second arch takes
# the two-request set of tests/test_serving.py to keep the file's time down
ENGINE_CASES = {"olmoe-1b-7b": all_requests,
                "granite-moe-1b-a400m": sequential_requests}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_the_jax_engines_tokens(arch, monkeypatch, capsys):
    """Requests of tests/test_serving.py through both engines: every token
    equal, and the same stats keys; then the launcher on the reduced
    config."""
    jcfg, jparams, cfg, params = setup(arch)
    # the JAX engine prefills eagerly; jit it (the same function) for speed
    monkeypatch.setattr(jax_engine.lm, "prefill", jax_prefill)
    slots, jreqs = ENGINE_CASES[arch](jax_engine.Request, cfg.vocab_size)
    _, reqs = ENGINE_CASES[arch](Request, cfg.vocab_size)
    jeng = jax_engine.ServeEngine(jcfg, jparams, slots=slots, max_seq=64)
    eng = ServeEngine(cfg, params, slots=slots, max_seq=64, device="cpu")
    for e, rs in ((jeng, jreqs), (eng, reqs)):
        for r in rs:
            e.submit(r)
        e.run(max_ticks=300)
    for r, jr in zip(reqs, jreqs):
        assert len(r.output) == r.max_new_tokens
        assert r.output == jr.output, r.rid
    assert eng.stats().keys() == jeng.stats().keys()
    assert eng.stats()["released"] == len(reqs)

    reqs = serve.main(["--arch", arch, "--requests", "3", "--slots", "2",
                       "--max-new", "4", "--device", "cpu"])
    assert [len(r.output) for r in reqs] == [4, 4, 4]
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out
