"""Chunked gated linear attention (GLA): the shared engine of mLSTM and
Mamba2 (port of `repro.models.gla`).

Both xLSTM's matrix-memory cell and Mamba2's SSD are instances of the same
recurrence with per-head *scalar* gates:

    S_t = exp(a_t) · S_{t-1} + b_t · k_t v_tᵀ          S: (K, V) per head
    y_t = q_tᵀ · S_t

Prefill uses the chunkwise-parallel form, decode the one-step recurrence.
a_t ≤ 0 keeps every exponential ≤ 1, so the chunked form is stable without
a running-max stabiliser. The JAX package computes it with plain `jnp`
(no Pallas kernel backs it), so it is plain PyTorch here.

`gla_chunked` takes the JAX package's chunk (the largest divisor of L not
above `chunk`) and computes each chunk's intra-chunk product, decayed
query and decayed key with its formulas, batched over the chunks, which do
not depend on one another; only the carried state is sequential, one
`torch.bmm` per chunk for the output's inter-chunk part and a multiply and
a `torch.baddbmm` for the state, where the JAX package's `lax.scan` runs
the whole body per chunk; the inter-chunk parts are added to the
intra-chunk products at once, as JAX adds `y_intra + y_inter`, and nothing
is written in place, so the scan is differentiable. A prompt of prime
length takes chunk 1: L steps.

On DTensors (a step or a cache laid out over a mesh) both run on each
rank's shards through `local_map` (`_sharded`): every (batch row, head)
is independent, so batch and head shards compute their own rows. A state
laid out over its K dim (the JAX cache rule for a batch-1 cache, under
`long_500k`) splits the q·k and q·S contractions: each rank's output is a
partial sum over its K rows, reduced by the all-reduce GSPMD inserts, and
its state keeps its own K rows.
"""
from __future__ import annotations

from typing import Tuple

import torch

_NEG = -1e30


def chunk_size(l: int, chunk: int) -> int:
    """The chunk `gla_chunked` takes for length l: the largest divisor of l
    not above `chunk` (1 for a prime l above it)."""
    c = min(chunk, l)
    while l % c:
        c -= 1
    return c


def _sharded(body, q, k, v, log_a, gate_b, s, k_dim: int):
    """`body(q, k, v, log_a, gate_b, s)` on each rank's shards of DTensor
    inputs (`k_dim` is q's and k's K dim; s is (B, H, K, V)). Per mesh dim
    of more than one rank: where the state shards its K dim, q and k shard
    theirs and v and the gates are whole, the output a partial sum (reduced
    here), the state its K rows (no gradient: a cache's layout); else where
    q shards its batch or heads, every input and the state shard the same
    dim; else all are replicated. A plain state (a forward's zeros) is laid
    out as the rows it meets. Returns (y, state)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.kernels import is_dtensor
    from repro_torch.sharding.rules import placed

    mesh = q.device_mesh
    qp, vp, sp, yp = [], [], [], []
    for i, pl in enumerate(q.placements):
        st = s.placements[i] if is_dtensor(s) else Replicate()
        if mesh.size(i) > 1 and st == Shard(2):
            qp.append(Shard(k_dim)), vp.append(Replicate())
            sp.append(st), yp.append(Partial())
        elif pl in (Shard(0), Shard(1)):
            qp.append(pl), vp.append(pl), sp.append(pl), yp.append(pl)
        else:
            qp.append(Replicate()), vp.append(Replicate())
            sp.append(Replicate()), yp.append(Replicate())
    if Partial() in yp and any(x.requires_grad for x in (q, k, v))  \
            and torch.is_grad_enabled():
        raise NotImplementedError("a state split over its K dim is a cache's "
                                  "layout: it has no gradient")
    ins = (qp, qp, vp, vp, vp, sp)
    y, state = local_map(body, out_placements=(yp, sp), in_placements=ins,
                         in_grad_placements=ins, device_mesh=mesh)(
        *(placed(x, p, mesh) for x, p in zip(
            (q, k, v, log_a, gate_b, s), ins)))
    return placed(y, [Replicate() if p == Partial() else p for p in yp]), state


def gla_chunked(
    q: torch.Tensor,        # (B, H, L, K)
    k: torch.Tensor,        # (B, H, L, K)
    v: torch.Tensor,        # (B, H, L, V)
    log_a: torch.Tensor,    # (B, H, L)   log decay, <= 0
    gate_b: torch.Tensor,   # (B, H, L)   input gate, >= 0
    s0: torch.Tensor,       # (B, H, K, V) initial state
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, H, L, V) in q's dtype, final state (B, H, K, V) f32)."""
    from repro_torch.kernels import is_dtensor

    if is_dtensor(q):
        return _sharded(lambda *a: gla_chunked(*a, chunk), q, k, v, log_a,
                        gate_b, s0, 3)
    b, h, l, kk = q.shape
    vv = v.shape[-1]
    c = chunk_size(l, chunk)
    nc = l // c
    f32 = torch.float32

    def chunks(x):  # (B, H, L, ...) -> (nc, B·H, C, ...), chunk-major
        x = x.to(f32).reshape(b * h, nc, c, *x.shape[3:])
        return x.transpose(0, 1).contiguous()

    qs, ks, vs = chunks(q), chunks(k), chunks(v)
    als, bs = chunks(log_a), chunks(gate_b)              # (nc, BH, C)
    cum = torch.cumsum(als, dim=-1)
    total = cum[..., -1:]                                # (nc, BH, 1)
    # intra-chunk: A_ij = (q_i·k_j)·exp(cum_i − cum_j)·b_j for j <= i
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    expnt = cum[..., :, None] - cum[..., None, :]        # (nc, BH, C, C)
    decay = torch.exp(torch.where(tril, expnt, torch.full_like(expnt, _NEG)))
    a_mat = torch.matmul(qs, ks.transpose(-1, -2)) * decay * bs[..., None, :]
    y = torch.matmul(a_mat, vs)                          # y_intra, then + y_inter
    qd = qs * torch.exp(cum)[..., None]
    kd_t = (ks * (torch.exp(total - cum) * bs)[..., None]).transpose(-1, -2)
    decay_total = torch.exp(total)[..., None]            # (nc, BH, 1, 1)

    s = s0.to(f32).reshape(b * h, kk, vv)
    y_inter = []
    for qn, kn, vn, an in zip(qd.unbind(0), kd_t.unbind(0), vs.unbind(0),
                              decay_total.unbind(0)):
        # inter-chunk: the carried state, then the state update
        y_inter.append(torch.bmm(qn, s))
        s = torch.baddbmm(s * an, kn, vn)
    y = (y + torch.stack(y_inter)).transpose(0, 1).reshape(b, h, l, vv).to(q.dtype)
    return y, s.reshape(b, h, kk, vv)


def gla_ref(q, k, v, log_a, gate_b, s0):
    """Sequential oracle (per-timestep recurrence) used by property tests."""
    f32, dtype = torch.float32, q.dtype
    q, k, v, log_a, gate_b = (x.to(f32) for x in (q, k, v, log_a, gate_b))
    s = s0.to(f32)
    ys = []
    for t in range(q.shape[2]):
        s = torch.exp(log_a[:, :, t])[..., None, None] * s + \
            gate_b[:, :, t][..., None, None] * (
                k[:, :, t, :, None] * v[:, :, t, None, :])
        ys.append(torch.einsum("bhk,bhkv->bhv", q[:, :, t], s))
    return torch.stack(ys, dim=2).to(dtype), s


def gla_step(q, k, v, log_a, gate_b, s):
    """One decode step. q/k: (B, H, K); v: (B, H, V); gates: (B, H);
    s: (B, H, K, V) f32."""
    from repro_torch.kernels import is_dtensor

    if is_dtensor(q):
        return _sharded(gla_step, q, k, v, log_a, gate_b, s, 2)
    f32 = torch.float32
    s = torch.exp(log_a.to(f32))[..., None, None] * s + \
        gate_b.to(f32)[..., None, None] * (
            k.to(f32)[..., :, None] * v.to(f32)[..., None, :])
    y = torch.einsum("bhk,bhkv->bhv", q.to(f32), s)
    return y.to(q.dtype), s


__all__ = ["chunk_size", "gla_chunked", "gla_ref", "gla_step"]
