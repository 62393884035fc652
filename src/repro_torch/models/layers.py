"""Shared neural building blocks over plain dicts of tensors (port of
`repro.models.layers`).

The initialisers draw from an explicit `torch.Generator` with the JAX
package's distributions (a unit normal times fan_in ** -0.5, rounded to the
param dtype); the two frameworks give different numbers from one seed, so
the tests carry the JAX params across instead (`lm.params_from_numpy`).
`chunked_cross_entropy` is the LM loss: it never holds (B, L, V) logits,
neither in the forward nor for the backward. The JAX package's layout pins
(`sharding.rules.shard_hint`) stand where it puts them; they act on
DTensors only.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.rules import (BATCH_AXES, matmul, shard_hint,
                                        split_last)


# -- initialisers -------------------------------------------------------------
def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype,
               fan_in: int | None = None) -> torch.Tensor:
    """Normal(0, 1) * fan_in ** -0.5 on the generator's device. `fan_in`
    defaults to shape[0]; a leaf stacked over layers passes it."""
    fan_in = fan_in if fan_in is not None else shape[0]
    x = torch.randn(shape, generator=gen, device=gen.device)
    return x.mul_(fan_in ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    return dense_init(gen, (vocab, d), dtype, fan_in=d)


# -- norms --------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


# -- rotary -------------------------------------------------------------------
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., L, hd); positions: (L,), or (B, 1, 1) per-slot positions
    that broadcast against x's (B, H, L)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    angles = positions[..., :, None].float() * freqs          # (..., L, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- FFN ----------------------------------------------------------------------
def swiglu_init(gen: torch.Generator, d: int, ff: int, dtype, lead=()):
    """[gate | up] fused input matrix and the output matrix; `lead` stacks
    them over layers."""
    lead = tuple(lead)
    return {
        "w_in": dense_init(gen, lead + (d, 2 * ff), dtype, fan_in=d),
        "w_out": dense_init(gen, lead + (ff, d), dtype, fan_in=ff),
    }


def swiglu_apply(params, x: torch.Tensor) -> torch.Tensor:
    ff = params["w_out"].shape[0]
    gate_up = split_last(matmul(x, params["w_in"].to(x.dtype)), (2, ff))
    gate_up = shard_hint(gate_up, BATCH_AXES, None, None, "model")
    out = matmul(F.silu(gate_up[..., 0, :]) * gate_up[..., 1, :],
                 params["w_out"].to(x.dtype))
    return shard_hint(out, BATCH_AXES, None, None)


# -- loss ---------------------------------------------------------------------
def _chunk_loss(h, head, y, m):
    """Summed masked CE of one chunk: logits `h @ head` in h's dtype, then
    f32, as the JAX package orders it. DTensor rows take
    `_sharded_chunk_loss`."""
    from repro_torch.kernels import is_dtensor

    h = shard_hint(h, BATCH_AXES, None, None)
    if is_dtensor(h):
        return _sharded_chunk_loss(h, head, y, m)
    return _rows_loss(h, head, y, m)


def _rows_loss(h, head, y, m):
    """The summed masked CE of rows `h` against the head (d, V)."""
    logits = (h @ head.to(h.dtype)).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
    return torch.sum((logz - gold) * m)


class _ShardCrossEntropy(torch.autograd.Function):
    """The summed masked CE of one rank's rows from its vocab shard's f32
    logits (ids `first` on): the max, the sum of exponentials and the gold
    logit are each reduced over the vocab shards' `groups` (three
    (rows, chunk) all-reduces), and the gradient, softmax minus one-hot,
    is the shard's own."""

    @staticmethod
    def forward(ctx, logits, y, m, first, groups):
        from torch.distributed import _functional_collectives as funcol

        def over_vocab(x, op):
            for g in groups:
                x = funcol.wait_tensor(funcol.all_reduce(x, op, g))
            return x

        top = over_vocab(logits.amax(dim=-1), "max")
        lse = top + torch.log(over_vocab(
            torch.sum(torch.exp(logits - top[..., None]), dim=-1), "sum"))
        idx = y.long() - first
        mine = (idx >= 0) & (idx < logits.shape[-1])
        idx = torch.where(mine, idx, 0)
        gold = torch.where(mine, torch.gather(logits, -1, idx[..., None])[..., 0],
                           0.0)
        gold = over_vocab(gold, "sum")
        ctx.save_for_backward(logits, lse, idx, mine, m)
        return torch.sum((lse - gold) * m)

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, mine, m = ctx.saved_tensors
        d = torch.exp(logits - lse[..., None])
        d.scatter_add_(-1, idx[..., None], -mine[..., None].to(d.dtype))
        return d * (m * g)[..., None], None, None, None, None


def _sharded_chunk_loss(h, head, y, m):
    """`_chunk_loss` of DTensor rows as GSPMD partitions it under the JAX
    package's pins (rows over the data axes, the logits' vocab over
    "model"): on each rank (`local_map`), the head gathered over its FSDP
    axis, the rank's logits `h @ head` of its rows and vocab shard, and
    `_ShardCrossEntropy` (`_rows_loss` itself where no mesh dim splits the
    vocab). DTensor's own logsumexp, and its gather along a sharded vocab,
    gather the (rows, chunk, V) logits whole (torch 2.13)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.rules import placed

    mesh = h.device_mesh
    rows = [p == Shard(0) for p in h.placements]
    coord = mesh.get_coordinate()
    vocab, first, width = [], 0, head.shape[-1]
    for i, r in enumerate(rows):
        vocab.append(not r and mesh.mesh_dim_names[i] == "model"
                     and mesh.size(i) > 1 and width % mesh.size(i) == 0)
        if vocab[-1]:
            width //= mesh.size(i)
            first += coord[i] * width
    hp = [Shard(0) if r else Replicate() for r in rows]
    wp = [Shard(1) if v else Replicate() for v in vocab]
    hg = [Shard(0) if r else Partial() if v else Replicate()
          for r, v in zip(rows, vocab)]
    wg = [Partial() if r else Shard(1) if v else Replicate()
          for r, v in zip(rows, vocab)]
    out = [Partial() if r else Replicate() for r in rows]
    groups = [mesh.get_group(i) for i, v in enumerate(vocab) if v]

    def body(hl, wl, yl, ml):
        if not groups:
            return _rows_loss(hl, wl, yl, ml)
        logits = (hl @ wl.to(hl.dtype)).float()
        return _ShardCrossEntropy.apply(logits, yl, ml, first, groups)

    # the mask may be a plain tensor, whole on every rank
    return local_map(body, out_placements=out,
                     in_placements=(hp, wp, hp, hp),
                     in_grad_placements=(hg, wg, hp, hp),
                     device_mesh=mesh)(placed(h, hp), placed(head, wp),
                                       placed(y, hp), placed(m, hp, mesh))


def chunked_cross_entropy(hidden: torch.Tensor, embed: torch.Tensor,
                          labels: torch.Tensor, mask: torch.Tensor | None = None,
                          chunk: int = 512,
                          transpose_head: bool = True) -> torch.Tensor:
    """Cross-entropy without materialising (B, L, V) logits (port of
    `repro.models.layers.chunked_cross_entropy`).

    hidden (B, L, d); embed the tied embedding (V, d) (`transpose_head`) or
    the head matrix (d, V); labels (B, L) integers; mask (B, L) or None.
    The sequence is cut into chunks of the largest divisor of L not above
    `chunk`, and each chunk's loss runs under a non-reentrant
    `checkpoint`, as JAX's `@jax.checkpoint` body: its (B, chunk, V) logits
    are recomputed in the backward, never kept. The f32 sum over the chunks
    is divided by max(sum(mask), 1)."""
    b, l, d = hidden.shape
    chunk = min(chunk, l)
    while l % chunk:  # the largest divisor of l not above chunk
        chunk -= 1
    head = embed.T if transpose_head else embed   # (d, V)
    if mask is None:
        mask = torch.ones((b, l), dtype=torch.float32, device=hidden.device)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, l, chunk):
        part = slice(start, start + chunk)
        total = total + checkpoint(_chunk_loss, hidden[:, part], head,
                                   labels[:, part], mask[:, part],
                                   use_reentrant=False)
    return total / torch.clamp_min(torch.sum(mask), 1.0)


__all__ = ["apply_rope", "chunked_cross_entropy", "dense_init", "embed_init",
           "rms_norm", "rope_freqs", "swiglu_apply", "swiglu_init"]
