"""The port's recurrent stacks against the JAX package, on the CPU.

Every block of the reduced xlstm-350m and zamba2-2.7b stacks (zamba2's
shared attention sites among them), each given the JAX package's input to
it, through forward, prefill (its cache leaf by leaf), scalar and per-slot
decode and a 1-token prompt, at 1e-5; the whole models through
`lm.forward`, `lm.prefill` (every cache leaf), scalar and per-slot
`lm.decode_step` and a 1-token prompt, then decode against forward on the
port. Params and helpers are tests/test_torch_ssm.py's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import stack as jax_stack
from repro_torch.models import lm, stack
from test_torch_ssm import (ARCHS, TOL, close, jax_decode, jax_forward,
                            jax_prefill, setup, t)

jax_block = jax.jit(jax_stack.block_apply, static_argnums=(1, 2))


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def blocks_of(cfg, jparams, params):
    """((segment, layer, block), kind, JAX params, port params) of every
    block of the stack, in order."""
    for s, (blocks, rep) in enumerate(cfg.segments):
        for layer in range(rep):
            jl = jax.tree.map(lambda a: a[layer], jparams["segments"][s])
            tl = stack._layer(params["segments"][s], layer)
            for i, kind in enumerate(blocks):
                yield (s, layer, i), kind, jl[f"b{i}"], tl[f"b{i}"]


@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_match_jax_in_the_stack(arch):
    """Every block of the reduced stack, each given the JAX package's input
    to it (its hidden after the blocks before), against JAX's block: the
    forward of 13 tokens, the prefill of 11 (the block's cache leaf by
    leaf), a scalar and a per-slot decode step from that cache, and the
    prefill of a 1-token prompt (the recurrent blocks' decode path)."""
    jcfg, jparams, cfg, params = setup(arch)
    shared = dict(shared=jparams.get("shared")), dict(shared=params.get("shared"))
    rng = np.random.default_rng(11)
    x = np.asarray(jparams["embed"])[rng.integers(0, cfg.vocab_size, (2, 13))]
    steps = (("forward", x, None), ("prefill", x[:, :11], 0),
             ("decode", x[:, 11:12], 11),
             ("per-slot decode", x[:, 12:13], np.asarray([12, 14], np.int32)),
             ("1-token prefill", x[:, :1], 0))
    jcaches, caches = {}, {}
    for what, h, pos in steps:
        if what.endswith("prefill"):
            jcaches.clear()
            caches.clear()
        if pos is None or what.endswith("prefill"):
            positions = np.arange(h.shape[1])
        else:
            positions = np.atleast_1d(pos)
        for where, kind, jp, p in blocks_of(cfg, jparams, params):
            if pos is not None and where not in caches:
                jcaches[where] = jax_stack.block_cache_init(jcfg, kind, 2, 24, jnp.float32)
                caches[where] = stack.block_cache_init(cfg, kind, 2, 24, torch.float32)
            jc, c = jcaches.get(where), caches.get(where)
            want, _, jc = jax_block(jp, jcfg, kind, h, positions=positions,
                                    cache=jc, cache_pos=pos, **shared[0])
            got, _, c = stack.block_apply(
                p, cfg, kind, t(h), positions=t(positions), cache=c,
                cache_pos=t(pos) if isinstance(pos, np.ndarray) else pos, **shared[1])
            close(got, want, f"{what}: block {where} ({kind})")
            if pos is not None:
                close(c, jc, f"{what}: block {where} ({kind}) cache")
                jcaches[where] = jc
            h = np.asarray(want)


#: the whole stack against JAX. zamba2-2.7b reduced holds 1e-5. Its blocks
#: hold 1e-5 too (test_blocks_match_jax_in_the_stack), but over the reduced
#: xlstm-350m's six blocks each package's f32 rounding (exp, tanh, the
#: sLSTM stabiliser's exponents near 30) grows to ~1e-5 of the hidden state:
#: the JAX package's jitted and eager forwards differ by 0.48 of 1e-5 on
#: these inputs, and the port's forward sits 0.7 to 2.3 of 1e-5 from the
#: jitted one over 8 token draws (4 of them past 1e-5)
STACK_TOL = {"xlstm-350m": dict(rtol=1e-4, atol=1e-4), "zamba2-2.7b": TOL}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch):
    """lm.forward, lm.prefill (every cache leaf), scalar and per-slot
    lm.decode_step and a 1-token prompt's prefill against the JAX
    package's, within STACK_TOL; then decode against forward on the port."""
    jcfg, jparams, cfg, params = setup(arch)
    near = functools.partial(close, tol=STACK_TOL[arch])

    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    want, jaux = jax_forward(jcfg, jparams, {"tokens": tokens})
    got, aux = lm.forward(cfg, params, {"tokens": t(tokens)})
    near(got, want, "forward hidden")
    close(aux, jaux, "forward aux")

    max_seq = 24
    for l in (1, 11):   # a 1-token prompt: the recurrent blocks' decode path
        want, jcaches = jax_prefill(jcfg, jparams, {"tokens": tokens[:, :l]}, max_seq)
        got, caches = lm.prefill(cfg, params, {"tokens": t(tokens[:, :l])}, max_seq)
        near(got, want, f"prefill logits, {l} tokens")
        near(caches, jcaches, f"prefill caches, {l} tokens")
    for pos in (11, np.asarray([12, 14], np.int32)):
        tok = tokens[:, 11:12] if not isinstance(pos, np.ndarray) else tokens[:, 12:13]
        want, jcaches = jax_decode(jcfg, jparams, jcaches, tok, jnp.asarray(pos))
        got, caches = lm.decode_step(cfg, params, caches, t(tok), t(pos) if
                                     isinstance(pos, np.ndarray) else pos)
        near(got, want, f"decode logits at {pos}")
        near(caches, jcaches, f"decode caches at {pos}")

    # tests/test_models.py::test_decode_matches_forward, on the port
    hidden, _ = lm.forward(cfg, params, {"tokens": t(tokens)})
    ref = lm.logits_for(cfg, params, hidden[:, -1:])[:, 0]
    _, caches = lm.prefill(cfg, params, {"tokens": t(tokens[:, :12])}, max_seq)
    logits, _ = lm.decode_step(cfg, params, caches, t(tokens[:, 12:]), 12)
    torch.testing.assert_close(logits, ref, rtol=2e-3, atol=2e-3)
