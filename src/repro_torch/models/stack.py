"""Segment stack machinery: block dispatch + a loop over layers (port of
`repro.models.stack`, every block kind).

A model is a sequence of segments ((block_types, repeat), ...). Parameters
for a segment are stacked along a leading `repeat` axis, as in the JAX
package, so that its params carry across as a tree map; where JAX scans
over that axis, the port loops over it in Python and layer i is
`leaf[i]`. Caches mirror the stacking: each segment holds a dict whose
leaves have leading dim `repeat`. Prefill and decode write each layer's
cache rows in place (attention: see models/attention.py; the recurrent
blocks' states are copied into their cache) and return the caches.
zamba2's "attn_shared" sites take their attention and FFN weights from
`shared` (`shared_block_init`, once per model) and keep their own norms
and KV caches; Whisper's "dec" blocks attend over the encoder's output
`enc_out`, or over the cross K/V that prefill stored in their cache.

The forward with no cache (`stack_apply`, what training differentiates)
takes each segment's layers apart with `torch.unbind`, so that the
backward stacks a leaf's per-layer gradients once, and runs each layer
under the JAX package's `remat` policy: "none", "full" (a non-reentrant
`checkpoint` of the layer) or "dots" (`dots_with_no_batch_dims_saveable`:
a selective checkpoint that keeps the outputs of the plain matrix products
x @ W and recomputes the rest).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models.attention import (cross_apply, cross_init, cross_kv,
                                          gqa_apply, gqa_cache_init, gqa_init,
                                          mla_apply, mla_cache_init, mla_init)
from repro_torch.models.layers import rms_norm, swiglu_apply, swiglu_init
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.sharding.rules import BATCH_AXES, assign, shard_hint
from repro_torch.models.ssm import (mamba2_apply, mamba2_cache_init,
                                    mamba2_decode, mamba2_init, mlstm_apply,
                                    mlstm_cache_init, mlstm_decode, mlstm_init,
                                    slstm_apply, slstm_cache_init, slstm_decode,
                                    slstm_init)

ATTN_KINDS = ("full", "swa", "enc", "full_moe", "attn_shared")
#: the recurrent kinds: (init, apply, decode, cache_init)
SSM_KINDS = {"mlstm": (mlstm_init, mlstm_apply, mlstm_decode, mlstm_cache_init),
             "slstm": (slstm_init, slstm_apply, slstm_decode, slstm_cache_init),
             "mamba2": (mamba2_init, mamba2_apply, mamba2_decode, mamba2_cache_init)}
#: every block kind of the JAX package's stack
PORTED_KINDS = ATTN_KINDS + ("mla", "dec") + tuple(SSM_KINDS)


def check_ported(kind: str) -> None:
    """Raise ValueError for a block kind the stack does not know, as the
    JAX package's `block_init` does."""
    if kind not in PORTED_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


def _layer(tree, i: int):
    """Layer i of a tree of stacked leaves: views, so writes reach the
    stacked tensors (a DTensor's too: its layer dim is never sharded, so
    the view's local tensor is a view of the stacked local shard)."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, tuple):
        return type(tree)(*(_layer(x, i) for x in tree))
    return {k: _layer(v, i) for k, v in tree.items()}


# ------------------------------------------------------------------ block init
def block_init(gen: torch.Generator, cfg, kind: str, dtype, lead=()):
    check_ported(kind)
    d = cfg.d_model
    zeros = lambda: torch.zeros(tuple(lead) + (d,), dtype=dtype, device=gen.device)
    if kind == "attn_shared":
        # weights live once at top level (params["shared"]); per-site norms only
        return {"ln1": zeros(), "ln2": zeros()}
    if kind in SSM_KINDS:
        return {"ln1": zeros(), "cell": SSM_KINDS[kind][0](gen, cfg, dtype, lead)}
    attn = (mla_init if kind == "mla" else gqa_init)(gen, cfg, dtype, lead)
    p = {"ln1": zeros(), "attn": attn}
    if kind == "dec":
        p["ln_x"] = zeros()
        p["cross"] = cross_init(gen, cfg, dtype, lead)
    p["ln2"] = zeros()
    if kind == "full_moe":
        p["moe"] = moe_init(gen, cfg, dtype, lead)
    else:
        p["mlp"] = swiglu_init(gen, d, cfg.d_ff, dtype, lead)
    return p


def shared_block_init(gen: torch.Generator, cfg, dtype):
    """zamba2-style shared attention + FFN weights (applied at every site)."""
    return {"attn": gqa_init(gen, cfg, dtype),
            "mlp": swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype)}


# ----------------------------------------------------------------- block apply
def block_apply(params, cfg, kind: str, x, *, positions, shared=None,
                enc_out=None, cache=None, cache_pos=None,
                q_chunk: int | None = None):
    """Returns (x, aux_loss, new_cache); only "full_moe" adds an auxiliary
    loss, and only with no cache (forward): prefill and decode read none,
    so it is not computed there (the others' aux is 0.0). A recurrent
    block's new state is written into `cache`, which is returned.
    `q_chunk` is the GQA attention backward's query chunk."""
    check_ported(kind)
    aux = 0.0
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if kind in SSM_KINDS:
        _, apply, decode, _ = SSM_KINDS[kind]
        is_decode = cache is not None and x.shape[1] == 1
        o, new = (decode if is_decode else apply)(params["cell"], cfg, h, cache)
        if cache is not None:
            for dst, src in zip(cache, new):
                assign(dst, src)
        return x + o, aux, cache
    if kind == "mla":
        o, new_cache = mla_apply(params["attn"], cfg, h, positions=positions,
                                 cache=cache, cache_pos=cache_pos)
    else:
        attn = shared["attn"] if kind == "attn_shared" else params["attn"]
        window = cfg.window if kind == "swa" else 0
        self_cache = cache["self"] if kind == "dec" and cache is not None else cache
        o, new_cache = gqa_apply(attn, cfg, h, window=window,
                                 positions=positions, cache=self_cache,
                                 cache_pos=cache_pos, causal=kind != "enc",
                                 q_chunk=q_chunk)
    x = x + o
    if kind == "dec":
        h = rms_norm(x, params["ln_x"], cfg.norm_eps)
        if cache is not None and "cross_k" in cache:
            kv = (cache["cross_k"], cache["cross_v"])
        else:
            kv = cross_kv(params["cross"], cfg, enc_out)
        x = x + cross_apply(params["cross"], cfg, h, kv)
        if cache is not None:
            new_cache = dict(cache, self=new_cache)
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    if kind == "full_moe":
        o, a = moe_apply(params["moe"], cfg, h, aux=cache is None)
        aux = aux if a is None else a
    else:
        o = swiglu_apply(shared["mlp"] if kind == "attn_shared" else params["mlp"], h)
    return x + o, aux, new_cache


# ----------------------------------------------------------------- block cache
def block_cache_init(cfg, kind: str, batch: int, max_seq: int, dtype,
                     device=None, lead=(), enc_len: int = 0):
    check_ported(kind)
    if kind in SSM_KINDS:
        return SSM_KINDS[kind][3](cfg, batch, dtype, device, lead)
    if kind == "mla":
        return mla_cache_init(cfg, batch, max_seq, dtype, device, lead)
    window = cfg.window if kind == "swa" else 0
    kv = gqa_cache_init(cfg, batch, max_seq, window, dtype, device, lead)
    if kind != "dec":
        return kv
    shape = tuple(lead) + (batch, cfg.num_heads, enc_len, cfg.hd)
    return {"self": kv,
            "cross_k": torch.zeros(shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(shape, dtype=dtype, device=device)}


# --------------------------------------------------------------- segment init
def stack_init(gen: torch.Generator, cfg, segments, dtype):
    """One dict per segment, {"b{i}": block params}, leaves stacked over the
    segment's `repeat`."""
    return [{f"b{i}": block_init(gen, cfg, kind, dtype, (rep,))
             for i, kind in enumerate(blocks)} for blocks, rep in segments]


def stack_cache_init(cfg, segments, batch: int, max_seq: int, dtype,
                     device=None, enc_len: int = 0):
    return [{f"b{i}": block_cache_init(cfg, kind, batch, max_seq, dtype,
                                       device, (rep,), enc_len)
             for i, kind in enumerate(blocks)} for blocks, rep in segments]


# -------------------------------------------------------------- forward passes
def _run(seg_params, caches, cfg, segments, x, *, positions, cache_pos,
         shared=None, enc_out=None):
    """Every layer in order, its caches written in place (prefill and
    decode, which read no aux loss)."""
    for s, ((blocks, rep), params) in enumerate(zip(segments, seg_params)):
        for layer in range(rep):
            lp, lc = _layer(params, layer), _layer(caches[s], layer)
            for i, kind in enumerate(blocks):
                x, _, _ = block_apply(lp[f"b{i}"], cfg, kind, x,
                                      positions=positions, shared=shared,
                                      enc_out=enc_out, cache=lc[f"b{i}"],
                                      cache_pos=cache_pos)
    return x


#: `remat` policies of `stack_apply`, as in the JAX package
REMAT = ("none", "dots", "full")
#: what "dots" saves: the outputs of the products without batch dimensions
#: (JAX's `dots_with_no_batch_dims_saveable`), which every x @ W of a
#: (B, L, d) activation and a weight matrix folds to; batched products
#: (`bmm`: the recurrent scans', the MoE experts') are recomputed, as there
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _unstack(tree, rep: int) -> list:
    """The `rep` per-layer trees of a tree of stacked leaves, by
    `torch.unbind`: a leaf's backward stacks its layers' gradients once,
    where indexing writes a whole leaf of zeros per layer."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    parts = {k: _unstack(v, rep) for k, v in tree.items()}
    return [{k: part[i] for k, part in parts.items()} for i in range(rep)]


def _layer_apply(lp, x, aux, *, cfg, blocks, positions, shared, enc_out,
                 q_chunk):
    """One layer's blocks with no cache: (x, aux plus their aux losses),
    the input pinned to batch-sharded rows as the JAX scan body pins it."""
    x = shard_hint(x, BATCH_AXES, None, None)
    for i, kind in enumerate(blocks):
        x, a, _ = block_apply(lp[f"b{i}"], cfg, kind, x, positions=positions,
                              shared=shared, enc_out=enc_out, q_chunk=q_chunk)
        if isinstance(a, torch.Tensor):
            aux = aux + a
    return x, aux


def stack_apply(seg_params, cfg, segments, x, *, positions, shared=None,
                enc_out=None, remat: str = "none",
                q_chunk: int | None = None):
    """Forward with no cache. Returns (x, total aux loss: an f32 scalar),
    summed over the blocks as the JAX package's scan sums it from 0 (0 for
    the dense kinds). `remat` ("none", "dots", "full") sets what each
    layer keeps for the backward (module docstring); `q_chunk` is the
    attention backward's query chunk."""
    if remat not in REMAT:
        raise ValueError(f"unknown remat {remat!r}; expected one of {REMAT}")
    context = {} if remat != "dots" else dict(context_fn=functools.partial(
        create_selective_checkpoint_contexts, list(_DOTS)))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for (blocks, rep), params in zip(segments, seg_params):
        body = functools.partial(_layer_apply, cfg=cfg, blocks=blocks,
                                 positions=positions, shared=shared,
                                 enc_out=enc_out, q_chunk=q_chunk)
        for lp in _unstack(params, rep):
            if remat == "none":
                x, aux = body(lp, x, aux)
            else:
                x, aux = checkpoint(body, lp, x, aux, use_reentrant=False,
                                    **context)
    return x, aux


def stack_prefill(seg_params, caches, cfg, segments, x, *, positions,
                  shared=None, enc_out=None):
    """Prefill: forward while writing caches at positions [0, L)."""
    x = _run(seg_params, caches, cfg, segments, x, positions=positions,
             cache_pos=0, shared=shared, enc_out=enc_out)
    return x, caches


def stack_decode(seg_params, caches, cfg, segments, x, pos, *, shared=None):
    """One-token decode. x: (B, 1, d); pos: an int or 0-d tensor (scalar
    absolute position) or a (B,) tensor of per-slot positions. A "dec"
    block reads its cross K/V from its cache."""
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        positions = pos
    else:
        positions = torch.tensor([int(pos)], device=x.device)
    x = _run(seg_params, caches, cfg, segments, x, positions=positions,
             cache_pos=pos, shared=shared)
    return x, caches


__all__ = ["ATTN_KINDS", "PORTED_KINDS", "REMAT", "SSM_KINDS", "block_apply",
           "block_cache_init", "block_init", "check_ported",
           "shared_block_init", "stack_apply", "stack_cache_init",
           "stack_decode", "stack_init", "stack_prefill"]
