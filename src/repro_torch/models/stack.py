"""Segment stack machinery: block dispatch + a loop over layers (port of
`repro.models.stack`, for the block kinds "full", "swa", "mla" and
"full_moe").

A model is a sequence of segments ((block_types, repeat), ...). Parameters
for a segment are stacked along a leading `repeat` axis, as in the JAX
package, so that its params carry across as a tree map; where JAX scans
over that axis, the port loops over it in Python and layer i is
`leaf[i]`. Caches mirror the stacking: each segment holds a dict whose
leaves have leading dim `repeat`. Prefill and decode write each layer's
cache rows in place (see models/attention.py) and return the caches.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import (gqa_apply, gqa_cache_init, gqa_init,
                                          mla_apply, mla_cache_init, mla_init)
from repro_torch.models.layers import rms_norm, swiglu_apply, swiglu_init
from repro_torch.models.moe import moe_apply, moe_init

#: block kinds the port builds; the others raise, naming the ROADMAP item
PORTED_KINDS = ("full", "swa", "mla", "full_moe")


def check_ported(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported to PyTorch yet (ROADMAP A13: "
            f"the port builds {PORTED_KINDS})")


def _layer(tree, i: int):
    """Layer i of a tree of stacked leaves: views, so writes reach the
    stacked tensors."""
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
    attn = (mla_init if kind == "mla" else gqa_init)(gen, cfg, dtype, lead)
    p = {"ln1": zeros(), "attn": attn, "ln2": zeros()}
    if kind == "full_moe":
        p["moe"] = moe_init(gen, cfg, dtype, lead)
    else:
        p["mlp"] = swiglu_init(gen, d, cfg.d_ff, dtype, lead)
    return p


# ----------------------------------------------------------------- block apply
def block_apply(params, cfg, kind: str, x, *, positions, cache=None,
                cache_pos=None):
    """Returns (x, aux_loss, new_cache); only "full_moe" adds an auxiliary
    loss, and only with no cache (forward): prefill and decode read none,
    so it is not computed there (the others' aux is 0.0)."""
    check_ported(kind)
    aux = 0.0
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if kind == "mla":
        o, new_cache = mla_apply(params["attn"], cfg, h, positions=positions,
                                 cache=cache, cache_pos=cache_pos)
    else:
        window = cfg.window if kind == "swa" else 0
        o, new_cache = gqa_apply(params["attn"], cfg, h, window=window,
                                 positions=positions, cache=cache,
                                 cache_pos=cache_pos, causal=True)
    x = x + o
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    if kind == "full_moe":
        o, a = moe_apply(params["moe"], cfg, h, aux=cache is None)
        aux = aux if a is None else a
    else:
        o = swiglu_apply(params["mlp"], h)
    return x + o, aux, new_cache


# ----------------------------------------------------------------- block cache
def block_cache_init(cfg, kind: str, batch: int, max_seq: int, dtype,
                     device=None, lead=()):
    check_ported(kind)
    if kind == "mla":
        return mla_cache_init(cfg, batch, max_seq, dtype, device, lead)
    window = cfg.window if kind == "swa" else 0
    return gqa_cache_init(cfg, batch, max_seq, window, dtype, device, lead)


# --------------------------------------------------------------- segment init
def stack_init(gen: torch.Generator, cfg, segments, dtype):
    """One dict per segment, {"b{i}": block params}, leaves stacked over the
    segment's `repeat`."""
    return [{f"b{i}": block_init(gen, cfg, kind, dtype, (rep,))
             for i, kind in enumerate(blocks)} for blocks, rep in segments]


def stack_cache_init(cfg, segments, batch: int, max_seq: int, dtype,
                     device=None):
    return [{f"b{i}": block_cache_init(cfg, kind, batch, max_seq, dtype,
                                       device, (rep,))
             for i, kind in enumerate(blocks)} for blocks, rep in segments]


# -------------------------------------------------------------- forward passes
def _run(seg_params, caches, cfg, segments, x, *, positions, cache_pos):
    """Every layer in order; caches (or None) written in place. Returns
    (x, the blocks' aux losses summed in layer order: 0.0, a float, when no
    block has one, so a dense model, a prefill and a decode launch no aux
    work)."""
    aux = 0.0
    for s, ((blocks, rep), params) in enumerate(zip(segments, seg_params)):
        for layer in range(rep):
            lp = _layer(params, layer)
            lc = _layer(caches[s], layer) if caches is not None else None
            for i, kind in enumerate(blocks):
                x, a, _ = block_apply(lp[f"b{i}"], cfg, kind, x,
                                      positions=positions,
                                      cache=None if lc is None else lc[f"b{i}"],
                                      cache_pos=cache_pos)
                if isinstance(a, torch.Tensor):
                    aux = aux + a
    return x, aux


def stack_apply(seg_params, cfg, segments, x, *, positions):
    """Forward with no cache. Returns (x, total aux loss: an f32 scalar),
    summed over the blocks as the JAX package's scan sums it from 0 (0 for
    the dense kinds)."""
    x, aux = _run(seg_params, None, cfg, segments, x, positions=positions,
                  cache_pos=None)
    if not isinstance(aux, torch.Tensor):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def stack_prefill(seg_params, caches, cfg, segments, x, *, positions):
    """Prefill: forward while writing caches at positions [0, L)."""
    x, _ = _run(seg_params, caches, cfg, segments, x, positions=positions,
                cache_pos=0)
    return x, caches


def stack_decode(seg_params, caches, cfg, segments, x, pos):
    """One-token decode. x: (B, 1, d); pos: an int or 0-d tensor (scalar
    absolute position) or a (B,) tensor of per-slot positions."""
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        positions = pos
    else:
        positions = torch.tensor([int(pos)], device=x.device)
    x, _ = _run(seg_params, caches, cfg, segments, x, positions=positions,
                cache_pos=pos)
    return x, caches


__all__ = ["PORTED_KINDS", "block_apply", "block_cache_init", "block_init",
           "check_ported", "stack_apply", "stack_cache_init", "stack_decode",
           "stack_init", "stack_prefill"]
