"""The port's encoder-decoder LM (Whisper) against the JAX package, on the
CPU.

Cross attention (`cross_kv`, `cross_apply`: decoder queries over encoder
frames, Lq ≠ Lk, non-causal), `lm.encode`, `lm.forward` with frames,
`lm.prefill` with its cross-K/V fill (every cache leaf), scalar and
per-slot `lm.decode_step` reading the cross K/V from the cache, for the
reduced whisper-base; decode against forward on the port; both engines'
refusal of an encoder-decoder model. The params are numpy draws in the JAX
package's tree (tests/test_torch_ssm.py's `draw_params`), carried across
with `lm.params_from_numpy`; frames and tokens are numpy draws from a seed.
Floats must match to rtol/atol 1e-5 (both sides compute in f32 at the
reduced config), cache structure exactly.
"""
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
from repro_torch.launch import serve
from repro_torch.models import attention, lm
from repro_torch.serving.engine import ServeEngine, check_servable
from test_torch_ssm import close, draw_params, t


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCH = "whisper-base"
MAX_SEQ = 24

jax_cross_kv = jax.jit(jax_attention.cross_kv, static_argnums=(1,))
jax_cross_apply = jax.jit(jax_attention.cross_apply, static_argnums=(1,))
jax_encode = jax.jit(jax_lm.encode, static_argnums=(0,))
jax_forward = jax.jit(jax_lm.forward, static_argnums=(0,))
jax_prefill = jax.jit(jax_lm.prefill, static_argnums=(0, 3))
jax_decode = jax.jit(jax_lm.decode_step, static_argnums=(0,))


@functools.lru_cache(maxsize=None)
def jax_setup():
    cfg = jax_get_config(ARCH, reduced=True)
    return cfg, draw_params(cfg)


@pytest.fixture
def setup():
    """(JAX cfg, JAX params, port cfg, the same params as CPU tensors)."""
    cfg, params = jax_setup()
    return (cfg, jax.tree.map(jnp.asarray, params), get_config(ARCH, reduced=True),
            lm.params_from_numpy(params, "cpu"))


def batch(cfg, b, l, seed):
    """Tokens (b, l) and stub frame embeddings (b, encoder_len, d)."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32),
            "frames": rng.standard_normal((b, cfg.encoder_len, cfg.d_model),
                                          np.float32)}


def tb(b):
    return {k: t(v) for k, v in b.items()}


def test_cross_attention_matches_jax(setup):
    """Decoder layer 1's cross attention: 5 queries over the 24 frames."""
    jcfg, jparams, cfg, params = setup
    jp = jax.tree.map(lambda a: a[1], jparams["segments"][0]["b0"]["cross"])
    p = {k: v[1] for k, v in params["segments"][0]["b0"]["cross"].items()}
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((2, cfg.encoder_len, cfg.d_model), np.float32)
    x = rng.standard_normal((2, 5, cfg.d_model), np.float32)
    jkv = jax_cross_kv(jp, jcfg, enc)
    kv = attention.cross_kv(p, cfg, t(enc))
    close(kv, jkv, "cross_kv")
    assert kv[0].shape == (2, cfg.num_heads, cfg.encoder_len, cfg.hd)
    close(attention.cross_apply(p, cfg, t(x), kv),
          jax_cross_apply(jp, jcfg, x, jkv), "cross_apply")


def test_encode_and_forward_match_jax(setup):
    jcfg, jparams, cfg, params = setup
    b = batch(cfg, 2, 13, 5)
    close(lm.encode(cfg, params, t(b["frames"])),
          jax_encode(jcfg, jparams, b["frames"]), "encode")
    want, jaux = jax_forward(jcfg, jparams, b)
    got, aux = lm.forward(cfg, params, tb(b))
    close(got, want, "forward hidden")
    close(aux, jaux, "forward aux")


def test_prefill_and_decode_match_jax(setup):
    """prefill fills each decoder layer's cross K/V from the encoded frames
    and its self-attention cache from the prompt; decode_step reads the
    cross K/V from the cache (no frames), at a scalar position and per
    slot. Then decode against forward on the port."""
    jcfg, jparams, cfg, params = setup
    b = batch(cfg, 2, 13, 7)
    pre = dict(b, tokens=b["tokens"][:, :11])
    want, jcaches = jax_prefill(jcfg, jparams, pre, MAX_SEQ)
    got, caches = lm.prefill(cfg, params, tb(pre), MAX_SEQ)
    close(got, want, "prefill logits")
    close(caches, jcaches, "prefill caches")
    assert caches[0]["b0"]["cross_k"].abs().sum() > 0
    for pos, tok in ((11, b["tokens"][:, 11:12]),
                     (np.asarray([12, 14], np.int32), b["tokens"][:, 12:13])):
        want, jcaches = jax_decode(jcfg, jparams, jcaches, tok, jnp.asarray(pos))
        got, caches = lm.decode_step(cfg, params, caches, t(tok), t(pos) if
                                     isinstance(pos, np.ndarray) else pos)
        close(got, want, f"decode logits at {pos}")
        close(caches, jcaches, f"decode caches at {pos}")

    # tests/test_models.py::test_decode_matches_forward, on the port
    hidden, _ = lm.forward(cfg, params, tb(b))
    ref = lm.logits_for(cfg, params, hidden[:, -1:])[:, 0]
    _, caches = lm.prefill(cfg, params, tb(dict(b, tokens=b["tokens"][:, :12])),
                           MAX_SEQ)
    logits, _ = lm.decode_step(cfg, params, caches, t(b["tokens"][:, 12:]), 12)
    torch.testing.assert_close(logits, ref, rtol=2e-3, atol=2e-3)


def test_both_engines_refuse_an_encoder_decoder_model(setup, monkeypatch):
    """The JAX engine admits a request by prefilling its tokens alone, and
    the JAX package's prefill reads batch["frames"] for Whisper: a KeyError.
    The port's engine refuses the model by name, and so does the launcher."""
    jcfg, jparams, cfg, params = setup
    monkeypatch.setattr(jax_engine.lm, "prefill", jax_prefill)
    jeng = jax_engine.ServeEngine(jcfg, jparams, slots=2, max_seq=MAX_SEQ)
    jeng.submit(jax_engine.Request(rid=0, prompt=np.arange(4), max_new_tokens=2))
    with pytest.raises(KeyError, match="frames"):
        jeng.step()
    with pytest.raises(NotImplementedError, match="whisper-base-reduced.*frames"):
        ServeEngine(cfg, params, slots=2, max_seq=MAX_SEQ, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        check_servable(get_config(ARCH))
    with pytest.raises(SystemExit, match="decoder-only"):
        serve.main(["--arch", ARCH, "--device", "cpu"])
