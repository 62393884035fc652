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
row of the buffer, which is never read. Under DTensor (a sharded train
step) the dispatch, the expert FFNs and the combine each run on the
rank's own rows through `local_map` (`_moe_sharded`), at the JAX package's
layout pins.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.sharding.rules import BATCH_AXES, placed, shard_hint


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


def _aux(logits: torch.Tensor, counts: torch.Tensor, entries: int,
         e: int) -> torch.Tensor:
    """E · Σ_i f_i · p_i from the routing entries' per-expert `counts` of
    `entries` in all, and the router `logits`."""
    f = counts / entries
    p = torch.softmax(logits, dim=-1).reshape(-1, e).mean(dim=0)
    return e * torch.sum(f * p)


def _counts(expert_idx: torch.Tensor, e: int) -> torch.Tensor:
    counts = torch.zeros((e,), dtype=torch.float32, device=expert_idx.device)
    return counts.index_add_(0, expert_idx.reshape(-1),
                             torch.ones(expert_idx.numel(), dtype=torch.float32,
                                        device=expert_idx.device))


def moe_aux(logits: torch.Tensor, expert_idx: torch.Tensor,
            e: int) -> torch.Tensor:
    """Switch-style load-balance loss E · Σ_i f_i · p_i over every token
    (global averages): f_i the share of the routing entries `expert_idx`
    that go to expert i, p_i its mean router probability."""
    return _aux(logits, _counts(expert_idx, e), expert_idx.numel(), e)


def _dispatch(x, router, *, cfg, t: int):
    """Route, sort and pack the groups of `x` (rows of `t` tokens each):
    (buf (G, E, cap, d), router logits (G, T, E) f32, gates (G, T, k), and
    the entries' sort order, slot, validity and source token, and their
    experts (G, T·k))."""
    d = x.shape[-1]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    g = x.numel() // (t * d)
    dt, dev = x.dtype, x.device
    xt = x.reshape(g, t, d)

    logits = (xt @ router.to(dt)).float()                         # (G, T, E)
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
    return buf, logits, gates, order, dest, valid, src_tok, expert_idx


def _experts(buf, w_in, w_out):
    """The expert FFNs (SwiGLU) as batched matmuls over the experts:
    (G, E, cap, d) -> (G, E, cap, d)."""
    dt = buf.dtype
    gu = torch.matmul(buf, w_in.to(dt))                           # (G, E, cap, 2ff)
    ff = w_out.shape[-2]
    h = F.silu(gu[..., :ff]) * gu[..., ff:]
    return torch.matmul(h, w_out.to(dt))


def _combine(out_e, gates, order, dest, valid, src_tok, *, shape):
    """Unpack the experts' rows and sum each token's gate-weighted entries
    into its row: -> `shape` (rows, L, d)."""
    g, e, cap, d = out_e.shape
    t = src_tok.shape[1] // gates.shape[-1]
    dt, dev = out_e.dtype, out_e.device
    gbase = torch.arange(g, device=dev)[:, None]
    out_e = out_e.reshape(g * e * cap, d)
    slot_out = out_e[torch.where(valid, gbase * (e * cap) + dest, 0).reshape(-1)]
    slot_out = slot_out * valid.reshape(-1, 1).to(dt)
    weighted = slot_out * torch.gather(gates.reshape(g, -1), 1,
                                       order).reshape(-1, 1)
    out = torch.zeros((g * t, d), dtype=dt, device=dev)
    out.index_add_(0, (gbase * t + src_tok).reshape(-1), weighted)
    return out.reshape((-1,) + tuple(shape[1:]))


def moe_apply(params, cfg, x: torch.Tensor, *, aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, L, d) -> (out (B, L, d), load-balance aux loss (f32 scalar),
    or None when `aux` is False: prefill and decode read no aux, and skip
    its softmax over the experts and its counts).

    Dispatch is grouped as in the JAX package: the tokens are split into G
    groups (cfg.moe_groups, decremented until it divides the tokens) and
    sorted, packed and dropped per group, with a per-group capacity. A
    DTensor `x` runs `_moe_sharded`.
    """
    b, l, d = x.shape
    t_all = b * l
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    g = max(cfg.moe_groups, 1)
    while t_all % g:
        g -= 1
    t = t_all // g                                                # tokens per group
    from repro_torch.kernels import is_dtensor

    if is_dtensor(x):
        return _moe_sharded(params, cfg, x, aux=aux, g=g, t=t)
    buf, logits, gates, order, dest, valid, src_tok, expert_idx = _dispatch(
        x, params["router"], cfg=cfg, t=t)
    out_e = _experts(buf, params["w_in"], params["w_out"])
    out = _combine(out_e, gates, order, dest, valid, src_tok, shape=x.shape)
    return out, moe_aux(logits, expert_idx, e) if aux else None


def _moe_sharded(params, cfg, x, *, aux: bool, g: int, t: int):
    """`moe_apply` of a DTensor x, as the JAX package's pins lay it out
    and GSPMD partitions it: the dispatch and the combine run on each
    rank's groups (`local_map`), the groups over the data axes where they
    divide them (the JAX package's shard-local dispatch, `moe_groups`), the
    tokens gathered otherwise (one global dispatch on every rank); the
    expert FFNs run on each rank's experts, the expert bank gathered over
    its FSDP axis, and their rows are gathered over "model" for the combine
    (the EP combine traffic). The router and the gathered expert weights
    are replicated over the axes that split the work, so their gradients
    are partial sums there."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    e = cfg.num_experts
    split = [names[i] in BATCH_AXES and mesh.size(i) > 1
             and g % mesh.size(i) == 0 and x.shape[0] % mesh.size(i) == 0
             for i in range(mesh.ndim)]
    xp = [Shard(0) if s else Replicate() for s in split]
    rep = [Replicate()] * mesh.ndim
    part = [Partial() if s else Replicate() for s in split]
    x = placed(x, xp)
    router = placed(params["router"], rep)
    buf, logits, gates, order, dest, valid, src_tok, expert_idx = local_map(
        functools.partial(_dispatch, cfg=cfg, t=t),
        out_placements=(xp,) * 8, in_placements=(xp, rep),
        in_grad_placements=(xp, part), device_mesh=mesh)(x, router)
    buf = shard_hint(buf, BATCH_AXES, None, None, None)

    # each mesh dim: groups split, experts split (the bank's own layout), or
    # the same work on every rank
    bp, wp, wg = [], [], []
    for i, s in enumerate(split):
        ep = (not s and params["w_in"].placements[i] == Shard(0)
              and e % mesh.size(i) == 0)
        bp.append(Shard(0) if s else Shard(1) if ep else Replicate())
        wp.append(Shard(0) if ep else Replicate())
        wg.append(Partial() if s else wp[-1])
    out_e = local_map(_experts, out_placements=bp, in_placements=(bp, wp, wp),
                      in_grad_placements=(bp, wg, wg), device_mesh=mesh)(
        placed(buf, bp), placed(params["w_in"], wp),
        placed(params["w_out"], wp))
    out_e = shard_hint(out_e, BATCH_AXES, None, None, None)

    combine = functools.partial(_combine, shape=(-1,) + tuple(x.shape[1:]))
    out = local_map(combine, out_placements=xp, in_placements=(xp,) * 6,
                    in_grad_placements=(xp,) * 6, device_mesh=mesh)(
        placed(out_e, xp), gates, order, dest, valid, src_tok)
    out = shard_hint(out, BATCH_AXES, None, None)
    if not aux:
        return out, None
    # each rank counts its groups' entries; the counts are summed over the
    # data axes that split the groups
    counts = local_map(functools.partial(_counts, e=e), out_placements=part,
                       in_placements=(xp,), device_mesh=mesh)(expert_idx)
    return out, _aux(logits, counts, expert_idx.numel(), e)


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
