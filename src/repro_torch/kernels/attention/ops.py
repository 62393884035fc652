"""Public attention API with backend dispatch (port of
`repro.kernels.attention.ops`), differentiable.

"cuda" launches the kernel, "torch" runs the plain version, "auto" picks
the kernel for CUDA tensors and the plain version for CPU tensors. Nothing
falls back: a CUDA tensor given to "cuda" or "auto" launches the kernel or
raises.

Training differentiates through attention. Neither the Pallas kernel nor
the CUDA one has a backward; the JAX package trains through its plain
`_attend_chunked`, whose query chunks run under `jax.checkpoint`, so its
backward recomputes each chunk's scores and never stores P. Here that is
`_Attention`, a `torch.autograd.Function`: its forward is the same
dispatch as above (the kernel for CUDA tensors), it saves only q, k and v,
and its backward is `attention_backward`, the JAX package's plain
recompute, chunk by chunk, on either device. It is taken only where grad
mode is on and an input requires grad; otherwise a call launches exactly
what it launched before.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention.flash import flash_attention_cuda
from repro_torch.kernels.attention.ref import attention_ref

BACKENDS = ("auto", "cuda", "torch")
#: query rows a backward chunk recomputes at once: `_attend_chunked`'s
#: default `q_chunk` (src/repro/models/attention.py)
Q_CHUNK = 512
_NEG = -1e30


def _forward(q, k, v, kernel: bool, **kw) -> torch.Tensor:
    if kernel:
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), **kw)
    return attention_ref(q, k, v, **kw)


def attention_backward(q, k, v, do, *, causal: bool = True, window: int = 0,
                       q_offset: int = 0, scale: float | None = None,
                       q_chunk: int = Q_CHUNK):
    """(dq, dk, dv) of `attention` at (q, k, v) against the output's
    gradient `do`, in the inputs' dtypes: the JAX package's `_attend_chunked`
    recomputed one query chunk (the largest divisor of Lq not above
    `q_chunk`) at a time under autograd, f32 scores times `scale` masked to
    -1e30, softmax, P·V, as `jax.checkpoint` recomputes it in JAX's
    backward. Only one chunk's (B, Hq, chunk, Lk) scores live at once; dk
    and dv are summed over the chunks in f32."""
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    dv_ = v.shape[-1]
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    c = min(q_chunk, lq)
    while lq % c:
        c -= 1
    kpos = torch.arange(lk, device=q.device)
    dq = torch.empty((b, hq, lq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, hkv, lk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((b, hkv, lk, dv_), dtype=torch.float32, device=q.device)
    with torch.enable_grad():
        k32 = k.detach().float().requires_grad_()
        v32 = v.detach().float().requires_grad_()
        for start in range(0, lq, c):
            qs = q[:, :, start:start + c].detach().float().requires_grad_()
            # the query heads of one KV head side by side: (B, Hkv, G·C, D)
            s = torch.matmul(qs.reshape(b, hkv, group * c, d),
                             k32.transpose(-1, -2)) * scale
            qpos = q_offset + start + torch.arange(c, device=q.device)
            mask = torch.ones((c, lk), dtype=torch.bool, device=q.device)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                mask &= kpos[None, :] > (qpos[:, None] - window)
            s = s.view(b, hkv, group, c, lk).masked_fill(~mask, _NEG)
            p = torch.softmax(s, dim=-1).view(b, hkv, group * c, lk)
            o = torch.matmul(p, v32).view(b, hq, c, dv_)
            gq, gk, gv = torch.autograd.grad(
                o, (qs, k32, v32), do[:, :, start:start + c].float())
            dq[:, :, start:start + c] = gq
            dk += gk
            dv += gv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Attention(torch.autograd.Function):
    """The forward of `attention` (the kernel or the plain version, as
    dispatched), the backward `attention_backward` from the saved q, k and
    v."""

    @staticmethod
    def forward(ctx, q, k, v, kernel, causal, window, q_offset, scale):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset,
                      scale=scale)
        return _forward(q, k, v, kernel, **ctx.kw)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        with torch.profiler.record_function("attention::backward"):
            grads = attention_backward(q, k, v, do, q_chunk=Q_CHUNK, **ctx.kw)
        return grads + (None,) * 5


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, q_offset: int = 0,
              scale: float | None = None, backend: str = "auto") -> torch.Tensor:
    """Multi-head GQA attention: q (B, Hq, Lq, D) over k (B, Hkv, Lk, D) and
    v (B, Hkv, Lk, Dv) -> (B, Hq, Lq, Dv); `scale` defaults to D ** -0.5.
    On the card a (D, Dv) pair the kernel is not built for raises
    NotImplementedError (flash.HEAD_DIMS). Differentiable: with grad mode
    on and an input requiring grad, the gradient is `attention_backward`."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    kernel = backend == "cuda" or (backend == "auto" and q.is_cuda)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _Attention.apply(q, k, v, kernel, causal, window, q_offset,
                                scale)
    return _forward(q, k, v, kernel, causal=causal, window=window,
                    q_offset=q_offset, scale=scale)


__all__ = ["BACKENDS", "Q_CHUNK", "attention", "attention_backward"]
