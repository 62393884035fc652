"""Top-k MoE with sort-based capacity dispatch (port of `repro.models.moe`).

Tokens are routed top-k, sorted by expert id, and packed into an
(E, capacity, d) buffer so the expert FFNs are dense batched matmuls,
(E, cap, d) × (E, d, 2ff), whose FLOPs equal the active compute only.
Overflowing tokens (rank ≥ capacity) are dropped, as the JAX package's
scatter drops them (`mode="drop"`): their gate mass is lost.

The JAX package runs the dispatch and the expert FFNs outside any Pallas
kernel, so here they are plain PyTorch ops (the expert products are
`torch.matmul`). The top-k is a stable descending sort, not `torch.topk`:
`jax.lax.top_k` takes the lower index first among equal logits, and
`torch.topk` does not (on rows of integer-valued logits their indices
differed in every row); router logits tie often enough (bf16 products over
64 experts) that `torch.topk` would route tokens to other experts.
The pack and the combine write with `index_copy_` and `index_add_` over
flat indices and need no host sync: the dropped entries go to one spare
row of the buffer, which is never read.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def moe_init(gen: torch.Generator, cfg, dtype, lead=()):
    """router (d, E), w_in (E, d, 2ff) and w_out (E, ff, d): unit normals
    times d ** -0.5 (router, w_in) and ff ** -0.5 (w_out), as the JAX
    package draws them; `lead` stacks them over layers."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = tuple(lead)
    return {
        "router": dense_init(gen, lead + (d, e), dtype, fan_in=d),
        "w_in": dense_init(gen, lead + (e, d, 2 * ff), dtype, fan_in=d),
        "w_out": dense_init(gen, lead + (e, ff, d), dtype, fan_in=ff),
    }


def moe_capacity(num_tokens: int, cfg) -> int:
    cap = int(num_tokens * cfg.num_experts_per_tok / cfg.num_experts * cfg.capacity_factor)
    return max(8, -(-cap // 8) * 8)  # round up to 8 for tiling


def top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k`: the k largest along the last axis, in descending
    order, equal values in index order (a stable descending sort)."""
    values, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def moe_aux(logits: torch.Tensor, expert_idx: torch.Tensor,
            e: int) -> torch.Tensor:
    """Switch-style load-balance loss E · Σ_i f_i · p_i over every token
    (global averages): f_i the share of the routing entries `expert_idx`
    that go to expert i, p_i its mean router probability."""
    dev = logits.device
    counts = torch.zeros((e,), dtype=torch.float32, device=dev)
    counts.index_add_(0, expert_idx.reshape(-1),
                      torch.ones(expert_idx.numel(), dtype=torch.float32,
                                 device=dev))
    f = counts / expert_idx.numel()
    p = torch.softmax(logits, dim=-1).reshape(-1, e).mean(dim=0)
    return e * torch.sum(f * p)


def moe_apply(params, cfg, x: torch.Tensor, *, aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, L, d) -> (out (B, L, d), load-balance aux loss (f32 scalar),
    or None when `aux` is False: prefill and decode read no aux, and skip
    its softmax over the experts and its counts).

    Dispatch is grouped as in the JAX package: the tokens are split into G
    groups (cfg.moe_groups, decremented until it divides the tokens) and
    sorted, packed and dropped per group, with a per-group capacity.
    """
    b, l, d = x.shape
    t_all = b * l
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    g = max(cfg.moe_groups, 1)
    while t_all % g:
        g -= 1
    t = t_all // g                                                # tokens per group
    dt = x.dtype
    dev = x.device
    xt = x.reshape(g, t, d)

    logits = (xt @ params["router"].to(dt)).float()               # (G, T, E)
    gate_logits, idx = top_k(logits, k)                           # (G, T, k)
    gates = torch.softmax(gate_logits, dim=-1).to(dt)

    cap = moe_capacity(t, cfg)
    expert_idx = idx.reshape(g, t * k)                            # (G, T·k)
    order = torch.argsort(expert_idx, dim=1, stable=True)
    sorted_e = torch.gather(expert_idx, 1, order)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(t * k, device=dev)[None] - first
    dest = sorted_e * cap + rank
    valid = rank < cap
    src_tok = order // k                                          # token of each entry
    gbase = torch.arange(g, device=dev)[:, None]

    # pack -> (G, E, cap, d); dropped entries land in the spare last row
    slots = g * e * cap
    flat_dest = torch.where(valid, gbase * (e * cap) + dest, slots).reshape(-1)
    rows = xt.reshape(g * t, d)[(gbase * t + src_tok).reshape(-1)]
    buf = torch.zeros((slots + 1, d), dtype=dt, device=dev)
    buf.index_copy_(0, flat_dest, rows)
    buf = buf[:slots].view(g, e, cap, d)

    # expert FFNs (SwiGLU): batched matmuls over the experts
    gu = torch.matmul(buf, params["w_in"].to(dt))                 # (G, E, cap, 2ff)
    ff = params["w_out"].shape[-2]
    h = F.silu(gu[..., :ff]) * gu[..., ff:]
    out_e = torch.matmul(h, params["w_out"].to(dt)).reshape(g * e * cap, d)

    # unpack + gate-weighted combine
    slot_out = out_e[torch.where(valid, gbase * (e * cap) + dest, 0).reshape(-1)]
    slot_out = slot_out * valid.reshape(-1, 1).to(dt)
    weighted = slot_out * torch.gather(gates.reshape(g, t * k), 1,
                                       order).reshape(-1, 1)
    out = torch.zeros((g * t, d), dtype=dt, device=dev)
    out.index_add_(0, (gbase * t + src_tok).reshape(-1), weighted)
    return out.reshape(b, l, d), moe_aux(logits, expert_idx, e) if aux else None


def moe_ref(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Dense oracle: every token through its top-k experts via full compute.

    O(T·E) FLOPs, test-only. Capacity drops are NOT modelled, so compare
    with capacity_factor large enough that nothing overflows.
    """
    b, l, d = x.shape
    t = b * l
    dt = x.dtype
    xt = x.reshape(t, d)
    logits = (xt @ params["router"].to(dt)).float()
    gate_logits, idx = top_k(logits, cfg.num_experts_per_tok)
    gates = torch.softmax(gate_logits, dim=-1).to(dt)
    ff = params["w_out"].shape[-2]
    gu = torch.matmul(xt, params["w_in"].to(dt))                  # (E, T, 2ff)
    all_out = torch.matmul(F.silu(gu[..., :ff]) * gu[..., ff:],
                           params["w_out"].to(dt))                # (E, T, d)
    picked = all_out[idx.T, torch.arange(t, device=x.device)[None]]   # (k, T, d)
    out = torch.sum(picked * gates.T[..., None], dim=0)
    return out.reshape(b, l, d)


__all__ = ["moe_apply", "moe_aux", "moe_capacity", "moe_init", "moe_ref", "top_k"]
