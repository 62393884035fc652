"""Shared neural building blocks over plain dicts of tensors (port of
`repro.models.layers`).

The initialisers draw from an explicit `torch.Generator` with the JAX
package's distributions (a unit normal times fan_in ** -0.5, rounded to the
param dtype); the two frameworks give different numbers from one seed, so
the tests carry the JAX params across instead (`lm.params_from_numpy`).
`chunked_cross_entropy` is the LM loss: it never holds (B, L, V) logits,
neither in the forward nor for the backward.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


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
    gate_up = (x @ params["w_in"].to(x.dtype)).reshape(x.shape[:-1] + (2, ff))
    return (F.silu(gate_up[..., 0, :]) * gate_up[..., 1, :]) @ params["w_out"].to(x.dtype)


# -- loss ---------------------------------------------------------------------
def _chunk_loss(h, head, y, m):
    """Summed masked CE of one chunk: logits `h @ head` in h's dtype, then
    f32, as the JAX package orders it."""
    logits = (h @ head.to(h.dtype)).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
    return torch.sum((logz - gold) * m)


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
