"""Public attention API with backend dispatch (port of
`repro.kernels.attention.ops`).

"cuda" launches the kernel, "torch" runs the plain version, "auto" picks
the kernel for CUDA tensors and the plain version for CPU tensors. Nothing
falls back: a CUDA tensor given to "cuda" or "auto" launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention.flash import flash_attention_cuda
from repro_torch.kernels.attention.ref import attention_ref

BACKENDS = ("auto", "cuda", "torch")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, q_offset: int = 0,
              scale: float | None = None, backend: str = "auto") -> torch.Tensor:
    """Multi-head GQA attention: q (B, Hq, Lq, D) over k (B, Hkv, Lk, D) and
    v (B, Hkv, Lk, Dv) -> (B, Hq, Lq, Dv); `scale` defaults to D ** -0.5.
    On the card a (D, Dv) pair the kernel is not built for raises
    NotImplementedError (flash.HEAD_DIMS)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "cuda" or (backend == "auto" and q.is_cuda):
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal,
                                    window=window, q_offset=q_offset,
                                    scale=scale)
    return attention_ref(q, k, v, causal=causal, window=window,
                         q_offset=q_offset, scale=scale)


__all__ = ["BACKENDS", "attention"]
