"""Segment stack machinery: block dispatch + a loop over layers (port of
`repro.models.stack`, for the block kinds "full" and "swa").

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

from repro_torch.models.attention import gqa_apply, gqa_cache_init, gqa_init
from repro_torch.models.layers import rms_norm, swiglu_apply, swiglu_init

#: block kinds the port builds; the others raise, naming the ROADMAP item
PORTED_KINDS = ("full", "swa")


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
    return {"ln1": zeros(), "attn": gqa_init(gen, cfg, dtype, lead),
            "ln2": zeros(), "mlp": swiglu_init(gen, d, cfg.d_ff, dtype, lead)}


# ----------------------------------------------------------------- block apply
def block_apply(params, cfg, kind: str, x, *, positions, cache=None,
                cache_pos=None):
    """Returns (x, aux_loss, new_cache); the dense kinds add no auxiliary
    loss (aux is 0.0)."""
    check_ported(kind)
    window = cfg.window if kind == "swa" else 0
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    o, new_cache = gqa_apply(params["attn"], cfg, h, window=window,
                             positions=positions, cache=cache,
                             cache_pos=cache_pos, causal=True)
    x = x + o
    x = x + swiglu_apply(params["mlp"], rms_norm(x, params["ln2"], cfg.norm_eps))
    return x, 0.0, new_cache


# ----------------------------------------------------------------- block cache
def block_cache_init(cfg, kind: str, batch: int, max_seq: int, dtype,
                     device=None, lead=()):
    check_ported(kind)
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
    """Every layer in order; caches (or None) written in place."""
    for s, ((blocks, rep), params) in enumerate(zip(segments, seg_params)):
        for layer in range(rep):
            lp = _layer(params, layer)
            lc = _layer(caches[s], layer) if caches is not None else None
            for i, kind in enumerate(blocks):
                x, _, _ = block_apply(lp[f"b{i}"], cfg, kind, x,
                                      positions=positions,
                                      cache=None if lc is None else lc[f"b{i}"],
                                      cache_pos=cache_pos)
    return x


def stack_apply(seg_params, cfg, segments, x, *, positions):
    """Forward with no cache. Returns (x, total aux loss), the loss 0 for
    the dense kinds."""
    x = _run(seg_params, None, cfg, segments, x, positions=positions,
             cache_pos=None)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def stack_prefill(seg_params, caches, cfg, segments, x, *, positions):
    """Prefill: forward while writing caches at positions [0, L)."""
    x = _run(seg_params, caches, cfg, segments, x, positions=positions,
             cache_pos=0)
    return x, caches


def stack_decode(seg_params, caches, cfg, segments, x, pos):
    """One-token decode. x: (B, 1, d); pos: an int or 0-d tensor (scalar
    absolute position) or a (B,) tensor of per-slot positions."""
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        positions = pos
    else:
        positions = torch.tensor([int(pos)], device=x.device)
    x = _run(seg_params, caches, cfg, segments, x, positions=positions,
             cache_pos=pos)
    return x, caches


__all__ = ["PORTED_KINDS", "block_apply", "block_cache_init", "block_init",
           "check_ported", "stack_apply", "stack_cache_init", "stack_decode",
           "stack_init", "stack_prefill"]
