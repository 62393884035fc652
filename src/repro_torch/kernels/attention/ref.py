"""Plain PyTorch GQA attention (causal / sliding-window): the CUDA
kernel's reference (port of `repro.kernels.attention.ref`).

Written in the JAX oracle's order: the KV heads repeated over their query
group, f32 scores times `scale`, masked to -inf, `exp(s - max)` with NaN
(rows with no visible key) set to 0, divided by `max(sum, 1e-20)`, then
the product with v, cast to q's dtype. It materialises the (B, Hq, Lq, Lk)
scores. The CPU path of every attention, and what csrc/flash.cu is held
against on the card (chip_smoke.py). With `return_lse` it also gives each
row's log-sum-exp of its visible scaled scores, as the kernel does: the
max plus the log of the sum, -inf for a row that sees no key (whose output
row is 0).
"""
from __future__ import annotations

import torch


def attention_ref(
    q: torch.Tensor,  # (B, Hq, Lq, D)
    k: torch.Tensor,  # (B, Hkv, Lk, D)
    v: torch.Tensor,  # (B, Hkv, Lk, Dv): the value head dim may differ (MLA)
    *,
    causal: bool = True,
    window: int = 0,          # 0 = unbounded; else keys in (qpos-window, qpos]
    q_offset: int = 0,        # absolute position of q[0] (decode/prefill chunking)
    scale: float | None = None,       # default D ** -0.5
    return_lse: bool = False,
):
    """-> (B, Hq, Lq, Dv) in q's dtype; with `return_lse`, (that, the
    rows' log-sum-exp (B, Hq, Lq) in float32)."""
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"query heads {hq} are not a multiple of KV heads {hkv}")
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale

    kr = k.repeat_interleave(group, dim=1)
    vr = v.repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kr.float().transpose(-1, -2)) * scale

    qpos = torch.arange(lq, device=q.device) + q_offset
    kpos = torch.arange(lk, device=q.device)
    mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.nan_to_num(torch.exp(s - m))
    total = p.sum(-1, keepdim=True)
    out = torch.matmul(p / total.clamp_min(1e-20), vr.float()).to(q.dtype)
    if not return_lse:
        return out
    # log(0) = -inf for a row that sees no key, whatever its (-inf) max
    lse = torch.where(total > 0, m + torch.log(total), float("-inf"))
    return out, lse[..., 0]


__all__ = ["attention_ref"]
