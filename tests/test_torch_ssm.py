"""The port's recurrent blocks against the JAX package, on the CPU.

The GLA scan (`gla_chunked` at a prime length, which takes chunk 1, a
length under the chunk and a nonzero initial state; `gla_ref`,
`gla_step`); the mLSTM, sLSTM and Mamba2 cells' apply with and without a
state and their decode (the sLSTM's MLP is the tanh GeLU, and the case
fails under the exact one); every block of the reduced xlstm-350m and
zamba2-2.7b stacks, each given the JAX package's input to it, through
forward, prefill (its cache leaf by leaf), scalar and per-slot decode and
a 1-token prompt
(tests/test_torch_ssm_lm.py, with the whole models); the engine's bf16
copy of the params, which leaves the f32 parameters of the recurrences
uncast (tests/test_torch_ssm_serving.py holds the engine's tokens). The params are numpy draws in the JAX package's tree, carried
across with `lm.params_from_numpy`; other inputs are numpy draws from a
seed. Floats must match to rtol/atol 1e-5 (both sides compute in f32 at
the reduced configs), cache structure exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import gla as jax_gla
from repro.models import lm as jax_lm
from repro.models import ssm as jax_ssm
from repro_torch.configs.registry import get_config
from repro_torch.models import gla, lm, ssm
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
ARCHS = ("xlstm-350m", "zamba2-2.7b")

jax_forward = jax.jit(jax_lm.forward, static_argnums=(0,))
jax_prefill = jax.jit(jax_lm.prefill, static_argnums=(0, 3))
jax_decode = jax.jit(jax_lm.decode_step, static_argnums=(0,))

#: the JAX package's init values of the vectors that are not 0: the
#: mLSTM's gate biases, the sLSTM's [i f z o] biases, Mamba2's decay and skip
INIT_VECTORS = {"g_bias": lambda n: np.repeat([-3.0, 3.0], n // 2),
                "bias": lambda n: np.repeat([-3.0, 3.0, 0.0, 0.0], n // 4),
                "a_log": lambda n: np.log(np.arange(1, n + 1)),
                "d_skip": lambda n: np.ones(n)}
#: vectors drawn as their init value + 0.1 · normal, so that every path they
#: feed counts (the norm scales, Mamba2's step and conv biases init to 0)
PERTURBED = ("ln1", "ln2", "ln_x", "final_scale", "enc_final_scale",
             "q_scale", "k_scale", "o_scale", "mlp_scale", "dt_bias",
             "conv_b") + tuple(INIT_VECTORS)


def draw_params(cfg, seed=0):
    """Numpy params in the JAX package's tree (`jax.eval_shape` of
    `init_params`: no compile) with its init's distributions: matrices
    normal / sqrt(fan-in), the conv weights 0.1 · normal, PERTURBED's
    vectors their init value + 0.1 · normal."""
    shapes = jax.eval_shape(lambda: jax_lm.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape)
        key = path[-1].key
        if key in PERTURBED:
            base = INIT_VECTORS.get(key, lambda n: np.zeros(n))(leaf.shape[-1])
            x = base + 0.1 * x
        elif key == "conv_w":
            x = 0.1 * x
        else:
            x = x / np.sqrt(leaf.shape[-1 if key == "embed" else -2])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def jax_setup(arch):
    cfg = jax_get_config(arch, reduced=True)
    return cfg, draw_params(cfg)


def setup(arch):
    """(JAX cfg, JAX params, port cfg, the same params as CPU tensors)."""
    cfg, params = jax_setup(arch)
    return (cfg, jax.tree.map(jnp.asarray, params), get_config(arch, reduced=True),
            lm.params_from_numpy(params, "cpu"))


def paths(tree):
    """The key path of every leaf (dict keys, list indices, state field
    names), in tree order."""
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def close(got, want, what, tol=TOL):
    """Every leaf of `got` (tensors) against `want` (JAX), in tree order,
    within `tol`; the two trees' key paths and shapes equal."""
    assert paths(got) == paths(want), what
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert tuple(b.shape) == a.shape, what
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=what, **tol)


def t(x):
    return torch.from_numpy(np.asarray(x))


# -- the GLA scan ---------------------------------------------------------------

# (L, chunk, nonzero initial state): 7 is prime (chunk 1); 5 < 8 (one
# chunk of 5); 12 over 5 takes chunk 4, three chunks
GLA_CASES = ((7, 4, False), (5, 8, False), (12, 5, True))


def gla_inputs(l, nonzero_s0, seed):
    rng = np.random.default_rng(seed)
    b, h, k, v = 2, 3, 4, 5
    q, kk = (rng.standard_normal((b, h, l, k), np.float32) for _ in range(2))
    vv = rng.standard_normal((b, h, l, v), np.float32)
    log_a = -np.abs(rng.standard_normal((b, h, l), np.float32))
    gate_b = np.abs(rng.standard_normal((b, h, l), np.float32))
    s0 = rng.standard_normal((b, h, k, v), np.float32) if nonzero_s0 else \
        np.zeros((b, h, k, v), np.float32)
    return q, kk, vv, log_a, gate_b, s0


@pytest.mark.parametrize("l,chunk,nonzero_s0", GLA_CASES)
def test_gla_matches_jax(l, chunk, nonzero_s0):
    xs = gla_inputs(l, nonzero_s0, l * chunk)
    want = jax.jit(jax_gla.gla_chunked, static_argnums=6)(*xs, chunk)
    got = gla.gla_chunked(*map(t, xs), chunk)
    close(got, want, f"gla_chunked L={l} chunk={chunk}")
    close(gla.gla_ref(*map(t, xs)), jax_gla.gla_ref(*xs), "gla_ref")
    close(got, gla.gla_ref(*map(t, xs)), "gla_chunked against gla_ref")
    q, k, v, log_a, gate_b, s0 = xs
    step = [x[:, :, 0] for x in (q, k, v, log_a, gate_b)] + [s0]
    close(gla.gla_step(*map(t, step)), jax_gla.gla_step(*step), "gla_step")


# -- the cells -----------------------------------------------------------------

CELLS = {"mlstm": ("xlstm-350m", "b0", jax_ssm.mlstm_apply, jax_ssm.mlstm_decode,
                   ssm.mlstm_apply, ssm.mlstm_decode),
         "slstm": ("xlstm-350m", "b2", jax_ssm.slstm_apply, jax_ssm.slstm_decode,
                   ssm.slstm_apply, ssm.slstm_decode),
         "mamba2": ("zamba2-2.7b", "b0", jax_ssm.mamba2_apply, jax_ssm.mamba2_decode,
                    ssm.mamba2_apply, ssm.mamba2_decode)}


def run_cell(kind, jp, jcfg, p, cfg, x):
    """Apply without a state, apply from that state, decode from the next:
    the three outputs and states of both packages."""
    _, _, japply, jdecode, apply, decode = CELLS[kind]
    l = x.shape[1] // 2
    steps = ((japply, apply, x[:, :l]), (japply, apply, x[:, l:2 * l]),
             (jdecode, decode, x[:, -1:]))
    jstate = state = None
    out = []
    for jfn, fn, xs in steps:
        jy, jstate = jax.jit(jfn, static_argnums=1)(jp, jcfg, xs, jstate)
        y, state = fn(p, cfg, t(xs), state)
        out.append(((y, state), (jy, jstate)))
    return out


@pytest.mark.parametrize("kind", CELLS)
def test_cell_matches_jax(kind, monkeypatch):
    arch, block = CELLS[kind][:2]
    jcfg, jparams, cfg, params = setup(arch)
    jp = jax.tree.map(lambda a: a[0], jparams["segments"][0][block]["cell"])
    p = {k: v[0] for k, v in params["segments"][0][block]["cell"].items()}
    x = np.random.default_rng(5).standard_normal((2, 13, cfg.d_model), np.float32)
    for (got, want), what in zip(run_cell(kind, jp, jcfg, p, cfg, x),
                                 ("apply", "apply from a state", "decode")):
        close(got, want, f"{kind} {what}")
    if kind == "slstm":
        # the post-MLP's GeLU is jax.nn.gelu's default, the tanh form: the
        # exact one misses JAX's outputs
        exact = torch.nn.functional.gelu
        monkeypatch.setattr(ssm.F, "gelu", lambda x, approximate: exact(x))
        (got, _), (want, _) = run_cell(kind, jp, jcfg, p, cfg, x)[0]
        assert not np.allclose(got.numpy(), np.asarray(want), **TOL)


#: the params that compute in f32 whatever the model dtype
F32_KEYS = ("r", "a_log", "dt_bias", "d_skip")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_params_keep_the_numbers_in_bf16(arch):
    """In bf16: the engine's copy casts `lm.MATRICES` (zamba2's shared
    attention and FFN among them) and leaves the rest in f32, the sLSTM's
    recurrent `r` and Mamba2's `a_log`, `dt_bias`, `d_skip` too; its
    prefill and per-slot decode logits and its f32 states equal those of
    the params as given, bit for bit (casting any of those four changes
    them: `dt_bias` the states only, bf16 rounding absorbs it in the
    logits)."""
    _, _, cfg, params = setup(arch)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    eng = ServeEngine(cfg, params, slots=1, max_seq=32, device="cpu")
    seen = set()
    for path, x in jax.tree_util.tree_leaves_with_path(eng.params):
        key = path[-1].key
        seen.add(key)
        assert x.dtype == (torch.bfloat16 if key in lm.MATRICES else torch.float32), key
    assert seen & set(F32_KEYS) == ({"r"} if arch == "xlstm-350m"
                                    else {"a_log", "dt_bias", "d_skip"})
    if arch == "zamba2-2.7b":
        assert eng.params["shared"]["attn"]["wq"].dtype == torch.bfloat16

    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 9))
    pos = torch.tensor([8])
    outs = []
    for p in (params, eng.params):
        got, caches = lm.prefill(cfg, p, {"tokens": t(tokens[:, :8])}, 32)
        step, caches = lm.decode_step(cfg, p, caches, t(tokens[:, 8:]), pos)
        assert step.dtype == torch.float32 and bool(torch.isfinite(step).all())
        outs.append((got, step, caches))
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
