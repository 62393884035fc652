"""The port's LM training path against the JAX package, on the CPU: the
chunked cross entropy, the attention gradient, `lm.loss_fn` and its
gradients, and the remat policies.

- `layers.chunked_cross_entropy`: value and gradients (hidden and head)
  against `jax.value_and_grad` of the JAX function, over several chunks,
  with and without a mask, tied and untied heads.
- the differentiable attention (`kernels/attention/ops.py`): dq, dk and dv
  against `jax.grad` of `_attend_chunked` with q_chunk < L, in every mode
  the models call (causal, a window, non-causal, Lq != Lk, GQA groups,
  Dv != D with MLA's scale), through the Function and through
  `attention_backward` with several chunks.
- `lm.loss_fn` and its gradients for the dense archs ("full" and "swa"
  blocks, a mask; tests/test_torch_lm_grads.py, test_torch_ssm_grads.py
  and test_torch_qk_norm_grads.py: the other eight archs); params are
  numpy draws in the JAX tree, carried with `lm.params_from_numpy`.
- remat "none", "dots" and "full" give the same loss and gradients, and
  "dots" recomputes no matrix product in the backward where "full" does.
Every comparison is in f32 at 1e-5 (rtol and atol), the port's f32
tolerance against JAX (tests/test_torch_lm.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.registry import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro_torch.configs.registry import get_config
from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.models import layers, lm
from repro_torch.train.trainer import loss_and_grads


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
#: the batch of the loss tests: B 2 × L 16
B, L = 2, 16

#: the JAX package's init values of the vectors that are not 0
INIT_VECTORS = {"g_bias": lambda n: np.repeat([-3.0, 3.0], n // 2),
                "bias": lambda n: np.repeat([-3.0, 3.0, 0.0, 0.0], n // 4),
                "a_log": lambda n: np.log(np.arange(1, n + 1)),
                "d_skip": lambda n: np.ones(n)}
#: vectors drawn as their init value + 0.1 · normal, so that every path they
#: feed counts
PERTURBED = ("ln1", "ln2", "ln_x", "final_scale", "enc_final_scale",
             "q_scale", "k_scale", "kv_scale", "o_scale", "mlp_scale",
             "dt_bias", "conv_b") + tuple(INIT_VECTORS)

jax_loss_grad = jax.jit(jax.value_and_grad(jax_lm.loss_fn, argnums=1),
                        static_argnums=(0,), static_argnames=("remat",))


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


def make_batch(cfg, seed, b=B, l=L, mask=False):
    """Numpy tokens, labels (and Whisper's frames, a 0/1 mask) from a seed."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    if mask:
        batch["mask"] = (rng.random((b, l)) < 0.7).astype(np.float32)
    return batch


def paths(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def close(got, want, what, tol=TOL, leaf_scaled=False):
    """Every leaf of `got` (tensors) against `want` (JAX), in tree order,
    within `tol` (its atol times the leaf's largest |want| where
    `leaf_scaled`); the two trees' key paths equal."""
    assert paths(got) == paths(want), what
    for path, a, b in zip(paths(want), jax.tree.leaves(want), jax.tree.leaves(got)):
        assert tuple(b.shape) == a.shape, (what, path)
        a = np.asarray(a)
        atol = tol["atol"] * (float(np.abs(a).max()) if leaf_scaled else 1.0)
        np.testing.assert_allclose(b.detach().numpy(), a, rtol=tol["rtol"],
                                   atol=atol, err_msg=f"{what} {path}")


def check_loss_and_grads(arch, batch, tol=TOL, leaf_scaled=False):
    """`lm.loss_fn`'s value and gradients against `jax.value_and_grad` of
    the JAX package's on the same params and batch."""
    jcfg, params = jax_setup(arch)
    cfg = get_config(arch, reduced=True)
    want_loss, want_grads = jax_loss_grad(jcfg, params, batch)
    loss, grads = loss_and_grads(cfg, lm.params_from_numpy(params, "cpu"),
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want_loss), **tol)
    close(grads, want_grads, arch, tol, leaf_scaled)


# -- the chunked cross entropy ------------------------------------------------
jax_ce_grad = jax.jit(
    jax.value_and_grad(jax_layers.chunked_cross_entropy, argnums=(0, 1)),
    static_argnames=("chunk", "transpose_head"))


@pytest.mark.parametrize("l,chunk,tied,masked", [
    (24, 8, True, True),        # 3 chunks, tied head, a mask
    (30, 8, False, False),      # the largest divisor of 30 not above 8: 5 chunks of 6
    (30, 8, True, False),
    (16, 512, False, True),     # one chunk
])
def test_chunked_cross_entropy_and_grads_match_jax(l, chunk, tied, masked):
    rng = np.random.default_rng(l + 2 * tied + masked)
    d, v = 16, 40
    hidden = rng.standard_normal((2, l, d)).astype(np.float32)
    head = (rng.standard_normal((v, d) if tied else (d, v)) / 4).astype(np.float32)
    labels = rng.integers(0, v, (2, l)).astype(np.int32)
    mask = (rng.random((2, l)) < 0.6).astype(np.float32) if masked else None

    want, (want_dh, want_dw) = jax_ce_grad(hidden, head, labels, mask=mask,
                                           chunk=chunk, transpose_head=tied)
    h, w = (torch.from_numpy(x).requires_grad_() for x in (hidden, head))
    got = layers.chunked_cross_entropy(
        h, w, torch.from_numpy(labels),
        mask=None if mask is None else torch.from_numpy(mask), chunk=chunk,
        transpose_head=tied)
    dh, dw = torch.autograd.grad(got, (h, w))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(want_dh), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), **TOL)


def test_chunked_cross_entropy_keeps_no_logits_for_the_backward():
    """Each chunk runs under checkpoint: the tensors saved for the backward
    hold no (B, chunk, V) logits, only the chunks' inputs."""
    hidden = torch.randn(2, 32, 8, requires_grad=True)
    head = torch.randn(8, 1000, requires_grad=True)
    labels = torch.randint(0, 1000, (2, 32))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel()) or t, lambda t: t):
        layers.chunked_cross_entropy(hidden, head, labels, chunk=8,
                                     transpose_head=False)
    assert saved and max(saved) < 2 * 8 * 1000


# -- the attention gradient ---------------------------------------------------

def _attend_loss(q, k, v, w, **kw):
    return jnp.sum(jax_attention._attend_chunked(q, k, v, **kw) * w)


#: dq, dk, dv of the JAX package's `_attend_chunked` against the cotangent w
jax_attention_grads = jax.jit(
    jax.grad(_attend_loss, argnums=(0, 1, 2)),
    static_argnames=("causal", "window", "q_offset", "q_chunk", "scale"))

#: (hq, hkv, lq, lk, d, dv, causal, window, q_offset, scale): every mode the
#: models call
MODES = {
    "causal, GQA": (4, 2, 24, 24, 16, 16, True, 0, 0, None),
    "causal, window": (4, 2, 24, 24, 16, 16, True, 8, 0, None),
    "non-causal (Whisper's encoder)": (4, 4, 20, 20, 16, 16, False, 0, 0, None),
    "cross attention, Lq != Lk": (4, 4, 12, 30, 16, 16, False, 0, 0, None),
    "GQA 8/1, D 80": (8, 1, 16, 16, 80, 80, True, 0, 0, None),
    "Dv != D (MLA's naive form)": (4, 4, 18, 18, 24, 16, True, 0, 0, 24 ** -0.5),
    "cached prefill, q_offset": (4, 2, 6, 20, 16, 16, True, 0, 14, None),
}


def attention_inputs(mode):
    hq, hkv, lq, lk, d, dv, causal, window, q_offset, scale = MODES[mode]
    rng = np.random.default_rng(lq * 100 + lk + d)
    arrays = (rng.standard_normal((2, hq, lq, d)), rng.standard_normal((2, hkv, lk, d)),
              rng.standard_normal((2, hkv, lk, dv)), rng.standard_normal((2, hq, lq, dv)))
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    return [a.astype(np.float32) for a in arrays], kw


@pytest.mark.parametrize("mode", list(MODES))
def test_attention_function_grads_match_jax(mode, monkeypatch):
    (q, k, v, w), kw = attention_inputs(mode)
    lq = q.shape[2]
    want = jax_attention_grads(q, k, v, w, q_chunk=lq // 2 if lq % 2 == 0 else 3,
                               **kw)
    # the Function, with its chunk cut below Lq so that the backward loops
    monkeypatch.setattr(ops, "Q_CHUNK", 5)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.attention(tq, tk, tv, **kw)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(w))
    for name, g, want_g in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g),
                                   err_msg=f"{mode} d{name}", **TOL)
    # attention_backward alone, at several chunkings, gives the same
    for q_chunk in (1, 4, 512):
        again = ops.attention_backward(*(torch.from_numpy(x) for x in (q, k, v, w)),
                                       q_chunk=q_chunk, **kw)
        for g, g2 in zip(got, again):
            torch.testing.assert_close(g2, g, rtol=1e-6, atol=1e-6)


def test_attention_backward_returns_the_inputs_dtypes_and_matches_autograd():
    """bf16 inputs: bf16 gradients, within a bf16 ulp of autograd through
    the plain version (which computes in f32 too)."""
    (q, k, v, w), kw = attention_inputs("causal, window")
    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v))
    do = torch.from_numpy(w).bfloat16()
    got = torch.autograd.grad(ops.attention(tq, tk, tv, **kw), (tq, tk, tv), do)
    want = torch.autograd.grad(attention_ref(tq, tk, tv, **kw), (tq, tk, tv), do)
    for g, g2 in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), g2.float(), rtol=1e-2, atol=1e-2)


def test_no_grad_attention_is_the_plain_call():
    """Nothing requires grad: the call is the dispatch of before, with no
    autograd node."""
    (q, k, v, _), kw = attention_inputs("causal, GQA")
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = ops.attention(tq, tk, tv, **kw)
    assert out.grad_fn is None
    torch.testing.assert_close(out, attention_ref(tq, tk, tv, **kw), rtol=0, atol=0)
    with torch.no_grad():
        out = ops.attention(tq.requires_grad_(), tk, tv, **kw)
    assert out.grad_fn is None


# -- loss_fn and its gradients ------------------------------------------------
@pytest.mark.parametrize("arch", ["yi-6b", "h2o-danube-1.8b"])
def test_loss_fn_and_grads_match_jax(arch):
    check_loss_and_grads(arch, make_batch(jax_setup(arch)[0], 7,
                                          mask=arch == "h2o-danube-1.8b"))


# -- remat ---------------------------------------------------------------------
class CountMatmuls(TorchDispatchMode):
    """Counts the plain matrix products dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def remat_run(arch, remat, batch):
    """(loss, grads, matrix products in the backward) under `remat`."""
    cfg = get_config(arch, reduced=True)
    params = lm.params_from_numpy(jax_setup(arch)[1], "cpu")
    leaves = [p.requires_grad_() for p in lm.tree_leaves(params)]
    loss = lm.loss_fn(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()},
                      remat=remat)
    with CountMatmuls() as counter:
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss, grads, counter.mm


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "olmoe-1b-7b", "whisper-base"])
def test_remat_policies_give_the_same_loss_and_grads(arch):
    batch = make_batch(jax_setup(arch)[0], 3)
    loss, grads, mm = remat_run(arch, "none", batch)
    counts = {}
    for remat in ("dots", "full"):
        loss2, grads2, counts[remat] = remat_run(arch, remat, batch)
        torch.testing.assert_close(loss2, loss, rtol=0, atol=0)
        for g, g2 in zip(grads, grads2):
            torch.testing.assert_close(g2, g, rtol=0, atol=0)
    # "dots" keeps the products' outputs; "full" recomputes the forward's
    assert counts["dots"] == mm < counts["full"]


def test_unknown_remat_raises():
    cfg = get_config("yi-6b", reduced=True)
    params = lm.params_from_numpy(jax_setup("yi-6b")[1], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, 0).items()}
    with pytest.raises(ValueError, match="unknown remat"):
        lm.loss_fn(cfg, params, batch, remat="offload")
