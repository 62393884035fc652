"""Shared neural building blocks over plain dicts of tensors (port of
`repro.models.layers`).

The initialisers draw from an explicit `torch.Generator` with the JAX
package's distributions (a unit normal times fan_in ** -0.5, rounded to the
param dtype); the two frameworks give different numbers from one seed, so
the tests carry the JAX params across instead (`lm.params_from_numpy`).
`chunked_cross_entropy` waits for the training port (ROADMAP A13.5).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


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


__all__ = ["apply_rope", "dense_init", "embed_init", "rms_norm", "rope_freqs",
           "swiglu_apply", "swiglu_init"]
