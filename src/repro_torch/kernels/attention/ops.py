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

DTensors (a step sharded over a `DeviceMesh`) run the same dispatch on
each rank's local shard, through `local_map` (`sharded_call`): batch over
the data axes, heads over "model", and keys where a cache is laid out
over its sequence: there each rank attends over its own keys, the kernel
gives each row's log-sum-exp beside its output, and `merge` combines the
ranks' outputs with two all-reduces. The kernel on the card, or the plain
version on the CPU, sees plain local tensors; the cost it logs is the
shard's, one device's work. A DTensor is never gathered into a full
tensor here, and the kernel's wrapper refuses one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.kernels.attention.flash import HEAD_DIMS, flash_attention_cuda
from repro_torch.kernels.attention.flash import cost as flash_cost
from repro_torch.kernels.attention.ref import attention_ref

BACKENDS = ("auto", "cuda", "torch")
#: query rows a backward chunk recomputes at once: `_attend_chunked`'s
#: default `q_chunk` (src/repro/models/attention.py)
Q_CHUNK = 512
#: the widest head dims a call is zero-padded from (to a built pair)
PAD_LIMIT = 128
_NEG = -1e30


def padded_pair(d: int, dv: int):
    """The built (D, Dv) pair a call of head dims (d, dv) is zero-padded to
    (the one of least D + Dv that covers both), or None where (d, dv) is
    built itself or a dim is above `PAD_LIMIT` (such a call is refused by
    the kernel). The reduced MiniCPM3's MLA heads, (24, 16), go to (32,
    32)."""
    if (d, dv) in HEAD_DIMS or max(d, dv) > PAD_LIMIT:
        return None
    fits = [p for p in HEAD_DIMS
            if p[0] >= d and p[1] >= dv and max(p) <= PAD_LIMIT]
    return min(fits, key=sum) if fits else None


def padded(fn, q, k, v, pair, *, scale=None, return_lse=False, **kw):
    """`fn(q, k, v, scale=..., **kw)` with q and k zero-padded to pair[0]
    and v to pair[1] in the head dim, the output sliced back to v's width
    (with `return_lse`, and the rows' log-sum-exp, which the padding leaves
    as it is). Zero columns add nothing to q·k, and v's zero columns only
    add output columns, so this is the unpadded function; the scale is
    passed as the unpadded D's default."""
    d, dv = q.shape[-1], v.shape[-1]
    q, k = F.pad(q, (0, pair[0] - d)), F.pad(k, (0, pair[0] - d))
    v = F.pad(v, (0, pair[1] - dv))
    scale = (d ** -0.5) if scale is None else scale
    if return_lse:
        out, lse = fn(q, k, v, scale=scale, return_lse=True, **kw)
        return out[..., :dv].contiguous(), lse
    return fn(q, k, v, scale=scale, **kw)[..., :dv].contiguous()


def _forward(q, k, v, kernel: bool, return_lse: bool = False, **kw):
    """The kernel (`kernel`) or the plain twin; with `return_lse`, (out,
    the rows' log-sum-exp)."""
    if kernels.COST_LOG is not None:
        b, hq, lq, d = q.shape
        heads = (hq, k.shape[1], d, v.shape[-1])
        kernels.log_cost("flash", lambda: flash_cost(
            b, heads, lq, k.shape[2], kw.get("causal", True),
            kw.get("window", 0), kw.get("q_offset", 0), q.element_size()))
    if kernel:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        pair = padded_pair(q.shape[-1], v.shape[-1])
        if pair is not None:
            return padded(flash_attention_cuda, q, k, v, pair,
                          return_lse=return_lse, **kw)
        return flash_attention_cuda(q, k, v, return_lse=return_lse, **kw)
    return kernels.plain(attention_ref, q, k, v, return_lse=return_lse, **kw)


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
    v, `q_chunk` query rows at a time."""

    @staticmethod
    def forward(ctx, q, k, v, kernel, causal, window, q_offset, scale,
                q_chunk):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset,
                      scale=scale)
        ctx.q_chunk = q_chunk
        return _forward(q, k, v, kernel, **ctx.kw)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        q_chunk = Q_CHUNK if ctx.q_chunk is None else ctx.q_chunk
        with torch.profiler.record_function("attention::backward"):
            grads = attention_backward(q, k, v, do, q_chunk=q_chunk, **ctx.kw)
        return grads + (None,) * 6


def _local(q, k, v, kernel: bool, q_chunk: int, kw) -> torch.Tensor:
    """One device's attention: the differentiable form where grad mode is
    on and an input requires grad, the dispatch alone otherwise."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _Attention.apply(q, k, v, kernel, kw["causal"], kw["window"],
                                kw["q_offset"], kw["scale"], q_chunk)
    return _forward(q, k, v, kernel, **kw)


def merge(o: torch.Tensor, lse: torch.Tensor, reduce=None) -> torch.Tensor:
    """Attention over the union of disjoint key ranges, from each range's
    output `o` (..., Dv) and row log-sum-exp `lse` (...): the ranges'
    outputs weighted by exp(lse - max lse), over the sum of the weights
    (flash-decoding's merge, and GSPMD's cross-shard softmax). A range in
    which a row sees no key (lse -inf, o 0) weighs 0; a row that sees none
    in any range gives 0, as `attention_ref` does. `reduce(x, op)` combines
    a tensor over the ranges, op "max" or "sum" (an all-reduce over the
    mesh dims that split the keys: two a call, the max, then the weighted
    sums and the weights in one); by default the ranges are stacked on dim
    0 of o and lse. Computed in f32, returned in o's dtype."""
    if reduce is None:
        reduce = lambda x, op: x.amax(0) if op == "max" else x.sum(0)
    m = reduce(lse, "max")
    w = torch.where(lse > float("-inf"), torch.exp(lse - m), 0.0)
    both = reduce(torch.cat([w[..., None] * o.float(), w[..., None]], -1),
                  "sum")
    num, den = both[..., :-1], both[..., -1:]
    return torch.where(den > 0, num / den.clamp_min(1e-30), 0.0).to(o.dtype)


def _all_reduce(mesh, dims):
    """`merge`'s `reduce` over the mesh dims `dims`: all-reduces (functional
    collectives, counted as DTensor's are) of one rank's local tensors."""
    import torch.distributed._functional_collectives as funcol

    def reduce(x, op):
        for i in dims:
            x = funcol.wait_tensor(funcol.all_reduce(x, op, (mesh, i)))
        return x

    return reduce


def sharded_call(local, q, k, v, rows=()):
    """`local(q, k, v, *rows, first=, lse=)` on each rank's shards of
    DTensors q (B, Hq, L, D), k and v (B, Hkv, S, ...): attention, or its
    plain per-slot form, over the rank's keys [first, first + S_local).
    `rows` are per-batch-row tensors (B, ...), laid out as q's batch. Where
    no mesh dim of more than one rank splits the keys, `local` returns the
    rank's output (lse=False, differentiable); where some do (a cache laid
    out over its sequence: `cache_specs`' batch-1 rule, or
    `seq_shard_decode`), it returns (o, lse) over its own keys and the
    ranks' pairs are merged across those mesh dims (`merge`: no gather of
    the keys); the key split serves inference and has no gradient.

    Per mesh dim: where q shards the batch, so do k and v; where q shards
    its heads, k and v shard theirs if their head count divides that mesh
    dim, and are replicated otherwise (GQA with fewer KV heads than the
    "model" axis: Yi-6B's 4 over 16), each rank then reading the KV heads
    of its own query heads. A GQA group is never split unevenly: where a
    rank's query heads would not line up with whole groups, or with one
    part of one group, the heads are replicated on that mesh dim instead.
    Where k and v shard their sequence, q is replicated on that mesh dim
    (one decode token: where its heads shard over the same axis, they are
    gathered for the split and cut back after). Anything else (a partial
    sum, another sharded dim) is replicated first; a mesh dim of one rank
    is left as it is. The gradient of a replicated K or V is a partial sum
    on the mesh dims where the query heads were split, and whole where the
    work was the same on every rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.rules import placed, shard_start

    mesh = q.device_mesh
    hq, hkv = q.shape[1], k.shape[1]
    group = hq // hkv
    qp, kp, gp, split = [], [], [], []
    rows_left, q_left, kv_left = q.shape[0], hq, hkv
    for i, pl in enumerate(q.placements):
        size, kpl = mesh.size(i), k.placements[i]
        if size == 1:
            qp.append(pl), kp.append(kpl), gp.append(kpl)
        elif kpl == Shard(2):
            split.append(i)
            qp.append(Replicate()), kp.append(kpl), gp.append(Replicate())
        elif pl == Shard(0) and rows_left % size == 0:
            rows_left //= size
            qp.append(Shard(0)), kp.append(Shard(0)), gp.append(Shard(0))
        elif pl == Shard(1) and q_left % size == 0:
            q_left //= size
            kv = Shard(1) if kv_left % size == 0 else Replicate()
            kv_left //= size if kv == Shard(1) else 1
            qp.append(Shard(1)), kp.append(kv)
            gp.append(kv if kv == Shard(1) else Partial())
        else:
            qp.append(Replicate()), kp.append(Replicate())
            gp.append(Replicate())
    q_lo, q_n = shard_start(hq, mesh, qp, 1)
    aligned = (q_lo % group == 0 and q_n % group == 0 if q_n >= group else
               group % q_n == 0 and q_lo // group == (q_lo + q_n - 1) // group)
    if not aligned:  # replicate the heads rather than split a group
        multi = [mesh.size(i) > 1 for i in range(mesh.ndim)]
        qp = [Replicate() if p == Shard(1) and m else p
              for p, m in zip(qp, multi)]
        kp = [Replicate() if p == Shard(1) and m else p
              for p, m in zip(kp, multi)]
        gp = [Replicate() if p in (Shard(1), Partial()) and m else p
              for p, m in zip(gp, multi)]
        q_lo, q_n = shard_start(hq, mesh, qp, 1)
    k_lo, _ = shard_start(hkv, mesh, kp, 1)
    first_key, _ = shard_start(k.shape[2], mesh, kp, 2)
    first, last = q_lo // group, (q_lo + q_n - 1) // group
    heads = slice(first - k_lo, last + 1 - k_lo)
    rp = [Shard(0) if p == Shard(0) else Replicate() for p in qp]
    rows = tuple(placed(r, rp, mesh) for r in rows)
    out_p = list(qp)
    reduce = _all_reduce(mesh, split)
    for x in (q, k, v):
        if split and torch.is_grad_enabled() and x.requires_grad:
            raise NotImplementedError(
                "attention over keys split across ranks serves inference "
                "only: it has no gradient")

    def body(ql, kl, vl, *rl):
        kl, vl = kl[:, heads], vl[:, heads]
        if not split:
            return local(ql, kl, vl, *rl, first=first_key, lse=False)
        o, lse = local(ql, kl, vl, *rl, first=first_key, lse=True)
        return merge(o, lse, reduce)

    n = len(rows)
    o = local_map(body, out_placements=out_p,
                  in_placements=(qp, kp, kp) + (rp,) * n,
                  in_grad_placements=(qp, gp, gp) + (rp,) * n,
                  device_mesh=mesh)(placed(q, qp), placed(k, kp),
                                    placed(v, kp), *rows)
    return placed(o, q.placements) if split else o


def _sharded(q, k, v, kernel: bool, q_chunk: int, kw) -> torch.Tensor:
    """`attention` of DTensors q, k and v: `_local` on each rank's shards
    (`sharded_call`); over keys split across ranks, the kernel's
    log-sum-exp output, with `q_offset` shifted by the rank's first key, and
    the ranks' outputs merged."""

    def local(ql, kl, vl, *, first, lse):
        if not lse:
            return _local(ql, kl, vl, kernel, q_chunk, kw)
        return _forward(ql, kl, vl, kernel, return_lse=True,
                        **dict(kw, q_offset=kw["q_offset"] - first))

    return sharded_call(local, q, k, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, q_offset: int = 0,
              scale: float | None = None, backend: str = "auto",
              q_chunk: int | None = None) -> torch.Tensor:
    """Multi-head GQA attention: q (B, Hq, Lq, D) over k (B, Hkv, Lk, D) and
    v (B, Hkv, Lk, Dv) -> (B, Hq, Lq, Dv); `scale` defaults to D ** -0.5.
    On the card a (D, Dv) pair the kernel is not built for is zero-padded
    to a built one where both dims are at most `PAD_LIMIT` (`padded_pair`)
    and raises NotImplementedError otherwise (flash.HEAD_DIMS). Differentiable: with grad mode
    on and an input requiring grad, the gradient is `attention_backward`,
    `q_chunk` query rows at a time (None: `Q_CHUNK` when the backward
    runs). DTensors run on each rank's shard (`_sharded`)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    kernel = backend == "cuda" or (backend == "auto" and q.is_cuda)
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    if kernels.is_dtensor(q):
        return _sharded(q, k, v, kernel, q_chunk, kw)
    return _local(q, k, v, kernel, q_chunk, kw)


__all__ = ["BACKENDS", "PAD_LIMIT", "Q_CHUNK", "attention", "attention_backward",
           "merge", "padded", "padded_pair", "sharded_call"]
