"""Attention blocks: GQA (full / sliding-window), MLA and Whisper's cross
attention, with KV caches (port of `repro.models.attention`).

Attention with no cache (non-causal in Whisper's encoder), prefill,
scalar-position decode and cross attention go through
`kernels.attention.ops.attention` (the JAX package's `_attend_chunked`): the
hand-written CUDA kernel (csrc/flash.cu) for CUDA tensors, the plain
`attention_ref` for CPU tensors. This is where the JAX package says the
Pallas kernel replaces its query-chunked jnp path. The per-slot decode
that `ServeEngine` runs every tick, and the ring (SWA) decode, stay plain
PyTorch einsums and softmax, as the JAX package computes them outside any
kernel: the engine's steady-state decode launches no attention kernel.

Cache layout (decode): k/v (B, Hkv, S_max, hd) written at `pos`;
sliding-window blocks keep S_max = window and write at `pos % window`
(ring), so danube caches are O(window). MLA caches the compressed latent
c_kv (B, S_max, kv_lora_rank) and the shared rotary key (B, S_max, rope).
Unlike the JAX package's functional updates, the cache tensors are written
IN PLACE and returned: `gqa_apply` and `mla_apply` mutate the cache they
are given. The JAX package's `shard_hint` layout pins stand where it puts
them in the GQA block (batch over the data axes, heads over "model"); they
act on DTensors only, and `ops.attention` runs the kernel on each rank's
shard of DTensor q, k and v.

MLA's naive form expands the latent to per-head keys (nope + rope = 96 at
MiniCPM3-4B) and values (v_head_dim = 64) and attends through the kernel's
(96, 64) instantiation; its absorbed form (`cfg.mla_absorb`, off in every
config) attends over the latent with (kv_lora_rank + rope, kv_lora_rank)
and one KV head, through the kernel's (288, 256) instantiation, whose tiles
take all the query heads of the one KV head together.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import is_dtensor
from repro_torch.kernels.attention import ops
from repro_torch.models.layers import apply_rope, dense_init, rms_norm
from repro_torch.sharding import rules
from repro_torch.sharding.rules import (BATCH_AXES, matmul, shard_hint,
                                        split_last)

_NEG = -1e30


# -- parameter init -----------------------------------------------------------
def gqa_init(gen: torch.Generator, cfg, dtype, lead=()):
    """wq, wk, wv, wo (and qk-norm scales); `lead` stacks them over layers."""
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    lead = tuple(lead)
    p = {
        "wq": dense_init(gen, lead + (d, hq * hd), dtype, fan_in=d),
        "wk": dense_init(gen, lead + (d, hkv * hd), dtype, fan_in=d),
        "wv": dense_init(gen, lead + (d, hkv * hd), dtype, fan_in=d),
        "wo": dense_init(gen, lead + (hq * hd, d), dtype, fan_in=hq * hd),
    }
    if cfg.qk_norm:
        p["q_scale"] = torch.zeros(lead + (hd,), dtype=dtype, device=gen.device)
        p["k_scale"] = torch.zeros(lead + (hd,), dtype=dtype, device=gen.device)
    return p


def mla_init(gen: torch.Generator, cfg, dtype, lead=()):
    """The JAX package's MLA tree: the query down-projection and its norm
    scale, the query up-projection, the kv down-projection (latent + shared
    rotary key) and its norm scale, the kv up-projection, the output;
    `lead` stacks them over layers."""
    d, hq = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    lead = tuple(lead)
    zeros = lambda n: torch.zeros(lead + (n,), dtype=dtype, device=gen.device)
    return {
        "w_dq": dense_init(gen, lead + (d, qr), dtype, fan_in=d),
        "q_scale": zeros(qr),
        "w_uq": dense_init(gen, lead + (qr, hq * (nope + rope)), dtype, fan_in=qr),
        "w_dkv": dense_init(gen, lead + (d, kvr + rope), dtype, fan_in=d),
        "kv_scale": zeros(kvr),
        "w_ukv": dense_init(gen, lead + (kvr, hq * (nope + vd)), dtype, fan_in=kvr),
        "wo": dense_init(gen, lead + (hq * vd, d), dtype, fan_in=hq * vd),
    }


# -- exact attention core -----------------------------------------------------
#: The JAX package's query-chunked attention computes `attention_ref`'s
#: function; here it is `ops.attention` itself (the kernel tiles the
#: queries, the plain version materialises the scores at once).
_attend_chunked = ops.attention


# -- GQA block ----------------------------------------------------------------
class KVCache(NamedTuple):
    k: torch.Tensor    # (B, Hkv, S, hd)
    v: torch.Tensor    # (B, Hkv, S, hd)


def gqa_cache_init(cfg, batch: int, max_seq: int, window: int, dtype,
                   device=None, lead=()) -> KVCache:
    """Zeroed caches; `lead` stacks them over layers."""
    s = min(window, max_seq) if window > 0 else max_seq
    shape = tuple(lead) + (batch, cfg.num_kv_heads, s, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _slot_attention(q, ck, cv, valid, hkv, return_lse: bool = False):
    """One-token attention over every cache slot under a (.., S) `valid`
    mask that broadcasts to (B, Hq, L, S): the JAX package's einsum and
    softmax, in f32. With `return_lse`, (that, each row's log-sum-exp of
    its valid scores, -inf where none is valid: `ops.merge`'s input)."""
    b, hq, l, hd = q.shape
    s_max = ck.shape[2]
    s = torch.matmul(q.reshape(b, hkv, hq // hkv * l, hd).float(),
                     ck.float().transpose(-1, -2)) * (hd ** -0.5)
    s = s.reshape(b, hq, l, s_max).masked_fill(~valid, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.reshape(b, hkv, -1, s_max),
                     cv.float()).reshape(b, hq, l, hd).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(s, dim=-1)
    seen = valid.expand(s.shape).any(-1)
    return o, torch.where(seen, lse, float("-inf"))


def _ring_valid(kpos, pos, s_max: int, window: int):
    """Which ring slots `kpos` hold a key visible at absolute position
    `pos` (a scalar, or (B, 1) per slot): the slot's absolute position,
    within the window and written."""
    abs_pos = kpos + (pos // s_max) * s_max
    abs_pos = torch.where(kpos > pos % s_max, abs_pos - s_max, abs_pos)
    return (abs_pos <= pos) & (abs_pos > pos - window) & (abs_pos >= 0)


def _cache_write(cache: "KVCache", k, v, cache_pos, l: int, ring: bool,
                 per_slot: bool) -> None:
    """k and v (B, Hkv, L, hd) into the cache in place, as the JAX
    package's functional updates place them: per slot at each row's
    position (ring: modulo the window), the last `window` positions of the
    ring, or L rows from a scalar start clamped to fit
    (`dynamic_update_slice`). DTensor caches take each rank's part into its
    local shard (`rules.write_rows`)."""
    s_max = cache.k.shape[2]
    if per_slot:
        slot = (cache_pos % s_max) if ring else cache_pos
        rows = torch.arange(k.shape[0], device=k.device)

        def write(d, x, first, row0):
            n = d.shape[0]
            sl, bi = ((slot, rows) if n == rows.shape[0] else
                      (slot[row0:row0 + n], rows[:n]))
            if first == 0 and d.shape[2] == s_max:
                d[bi, :, sl] = x[:, :, 0]
                return
            sl = sl - first
            inside = (sl >= 0) & (sl < d.shape[2])
            sl = sl.clamp(0, d.shape[2] - 1)
            d[bi, :, sl] = torch.where(inside[:, None, None], x[:, :, 0],
                                       d[bi, :, sl])
    elif ring:
        # keep only the last `window` positions
        take = min(l, s_max)
        slots = (cache_pos + l - take + torch.arange(
            take, device=k.device)) % s_max

        def write(d, x, first, row0):
            if first == 0 and d.shape[2] == s_max:
                d[:, :, slots] = x[:, :, l - take:]
                return
            p0 = int(cache_pos) + l - take
            keep = [j for j in range(take)
                    if 0 <= (p0 + j) % s_max - first < d.shape[2]]
            if keep:
                at = torch.tensor([(p0 + j) % s_max - first for j in keep],
                                  device=d.device)
                d[:, :, at] = x[:, :, l - take:][:, :, torch.tensor(
                    keep, device=d.device)]
    else:
        # dynamic_update_slice semantics: the start clamps so that the L new
        # positions fit
        start = min(max(int(cache_pos), 0), s_max - l)

        def write(d, x, first, row0):
            lo, hi = max(start, first), min(start + l, first + d.shape[2])
            if lo < hi:
                d[:, :, lo - first:hi - first] = (
                    x if hi - lo == l else x[:, :, lo - start:hi - start])
    rules.write_rows(cache.k, k, write, 2)
    rules.write_rows(cache.v, v, write, 2)


def _slot_attend(q, ck, cv, cache_pos, ring: bool, per_slot: bool,
                 window: int):
    """The plain one-token attention over the cache's slots (ring or per
    slot) under the JAX package's validity masks; on DTensors each rank
    over its shards, the ranks' parts merged where the slots are split
    (`ops.sharded_call`)."""
    s_max = ck.shape[2]
    rows = (cache_pos,) if per_slot else ()

    def local(ql, kl, vl, *pos, first, lse):
        kpos = torch.arange(first, first + kl.shape[2], device=kl.device)
        if per_slot:
            p = pos[0][:, None]
            if ring:
                valid = _ring_valid(kpos[None, :], p, s_max, window)
            else:
                valid = kpos[None, :] <= p
                if window > 0:
                    valid &= kpos[None, :] > p - window
            valid = valid[:, None, None, :]
        else:
            valid = _ring_valid(kpos, cache_pos, s_max, window)
        return _slot_attention(ql, kl, vl, valid, kl.shape[1], return_lse=lse)

    if is_dtensor(q):
        return ops.sharded_call(local, q, ck, cv, rows)
    return local(q, ck, cv, *rows, first=0, lse=False)


def gqa_apply(
    params,
    cfg,
    x: torch.Tensor,                  # (B, L, d)
    *,
    window: int = 0,
    positions: Optional[torch.Tensor] = None,    # (L,)
    cache: Optional[KVCache] = None,
    cache_pos=None,                   # absolute position of x[0]: an int or
                                      # 0-d tensor, or (B,) per slot
    causal: bool = True,
    q_chunk: int | None = None,       # query rows of a backward recompute
                                      # (None: ops.Q_CHUNK)
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    b, l, d = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = x.dtype
    positions = positions if positions is not None else torch.arange(l, device=x.device)
    per_slot = (cache is not None and isinstance(cache_pos, torch.Tensor)
                and cache_pos.dim() == 1)

    q = split_last(matmul(x, params["wq"].to(dt)), (hq, hd))
    k = split_last(matmul(x, params["wk"].to(dt)), (hkv, hd))
    v = split_last(matmul(x, params["wv"].to(dt)), (hkv, hd))
    if cfg.qk_norm:
        q = rms_norm(q, params["q_scale"], cfg.norm_eps)
        k = rms_norm(k, params["k_scale"], cfg.norm_eps)
    rope_pos = cache_pos[:, None, None] if per_slot else positions  # (B,1,1) or (L,)
    q = apply_rope(q.transpose(1, 2), rope_pos, cfg.rope_theta)    # (B, Hq, L, hd)
    k = apply_rope(k.transpose(1, 2), rope_pos, cfg.rope_theta)    # (B, Hkv, L, hd)
    v = v.transpose(1, 2)
    # pin the TP layout: batch on (pod, data), heads on model where they
    # divide it (KV heads that do not are replicated within their group)
    q = shard_hint(q, BATCH_AXES, "model", None, None)
    k = shard_hint(k, BATCH_AXES, "model", None, None)
    v = shard_hint(v, BATCH_AXES, "model", None, None)

    new_cache = None
    if cache is not None:
        ck, cv = cache.k, cache.v
        s_max = ck.shape[2]
        ring = window > 0 and s_max == window
        _cache_write(cache, k, v, cache_pos, l, ring, per_slot)
        new_cache = KVCache(ck, cv)
        if per_slot or (ring and l == 1):
            # one token over the slots valid for each batch row (per slot),
            # or over the ring's slots at their ring-aware positions
            o = _slot_attend(q, ck, cv, cache_pos, ring, per_slot, window)
        elif ring:
            # SWA prefill (single-shot, cache_pos == 0): attend over the local
            # window of the fresh k/v directly; the ring holds the tail.
            o = ops.attention(q, k, v, causal=True, window=window)
        else:
            # causal w.r.t. absolute positions: kpos <= qpos also masks the
            # not-yet-written tail of the cache (all written slots < pos+l).
            o = ops.attention(q, ck, cv, causal=True, window=window,
                              q_offset=int(cache_pos))
    else:
        o = ops.attention(q, k, v, causal=causal, window=window,
                          q_chunk=q_chunk)

    o = shard_hint(o, BATCH_AXES, "model", None, None)
    out = matmul(o.transpose(1, 2).reshape(b, l, hq * hd), params["wo"].to(dt))
    out = shard_hint(out, BATCH_AXES, None, None)
    return out, new_cache


# -- MLA block ----------------------------------------------------------------
class MLACache(NamedTuple):
    c_kv: torch.Tensor     # (B, S, kv_lora_rank) compressed latent
    k_rope: torch.Tensor   # (B, S, rope_dim) shared positional key


def mla_cache_init(cfg, batch: int, max_seq: int, dtype, device=None,
                   lead=()) -> MLACache:
    """Zeroed caches; `lead` stacks them over layers."""
    lead = tuple(lead)
    return MLACache(
        torch.zeros(lead + (batch, max_seq, cfg.kv_lora_rank), dtype=dtype,
                    device=device),
        torch.zeros(lead + (batch, max_seq, cfg.qk_rope_head_dim), dtype=dtype,
                    device=device))


def mla_apply(
    params,
    cfg,
    x: torch.Tensor,                  # (B, L, d)
    *,
    positions: Optional[torch.Tensor] = None,    # (L,)
    cache: Optional[MLACache] = None,
    cache_pos=None,                   # absolute position of x[0]: an int or 0-d tensor
) -> Tuple[torch.Tensor, Optional[MLACache]]:
    b, l, d = x.shape
    hq = cfg.num_heads
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    dt = x.dtype
    if cache is not None and isinstance(cache_pos, torch.Tensor) and cache_pos.dim():
        raise NotImplementedError(
            "mla_apply takes a scalar cache_pos: the JAX package's mla_apply "
            "writes its cache with dynamic_update_slice at (0, cache_pos, 0) "
            "(src/repro/models/attention.py:278), which takes scalar indices "
            f"only; got positions of shape {tuple(cache_pos.shape)}")
    positions = positions if positions is not None else torch.arange(l, device=x.device)

    # queries
    cq = rms_norm(matmul(x, params["w_dq"].to(dt)), params["q_scale"],
                  cfg.norm_eps)
    q = split_last(matmul(cq, rules.head_columns(params["w_uq"].to(dt), hq)),
                   (hq, nope + rope))
    q_rope = apply_rope(q[..., nope:].transpose(1, 2), positions, cfg.rope_theta)  # (B,H,L,rope)
    q_nope = q[..., :nope].transpose(1, 2)

    # compressed kv latent + shared rotary key
    dkv = matmul(x, params["w_dkv"].to(dt))                 # (B, L, kvr + rope)
    c_kv = rms_norm(dkv[..., :kvr], params["kv_scale"], cfg.norm_eps)
    k_rope_new = apply_rope(dkv[..., kvr:][:, None], positions, cfg.rope_theta)[:, 0]

    new_cache = None
    if cache is not None:
        # dynamic_update_slice semantics: the start clamps so that the L new
        # positions fit
        s_max = cache.c_kv.shape[1]
        start = min(max(int(cache_pos), 0), s_max - l)

        def write(dst, src, first, row0):
            lo, hi = max(start, first), min(start + l, first + dst.shape[1])
            if lo < hi:
                dst[:, lo - first:hi - first] = (
                    src if hi - lo == l else src[:, lo - start:hi - start])

        rules.write_rows(cache.c_kv, c_kv, write, 1)
        rules.write_rows(cache.k_rope, k_rope_new, write, 1)
        new_cache = cache
        c_kv_all, k_rope_all = cache.c_kv, cache.k_rope
        q_offset = int(cache_pos)
    else:
        c_kv_all, k_rope_all = c_kv, k_rope_new
        q_offset = 0
    # causal: kpos <= qpos also masks the unwritten cache tail

    scale = (nope + rope) ** -0.5  # scale uses the full qk dim
    if cfg.mla_absorb:
        # absorbed form: W_uk folds into the query and W_uv into the output,
        # so keys and values are the latent, shared across heads
        w_ukv = split_last(params["w_ukv"].to(dt), (hq, nope + vd))
        w_uk, w_uv = w_ukv[..., :nope], w_ukv[..., nope:]   # (kvr, H, nope), (kvr, H, vd)
        q_lat = torch.einsum("bhln,khn->bhlk", q_nope, w_uk)
        q_eff = torch.cat([q_lat, q_rope], dim=-1)          # (B, H, L, kvr + rope)
        q_eff = shard_hint(q_eff, BATCH_AXES, "model", None, None)
        k_eff = torch.cat([c_kv_all, k_rope_all.to(c_kv_all.dtype)],
                          dim=-1)[:, None]                  # (B, 1, S, kvr + rope)
        o_lat = ops.attention(q_eff, k_eff, c_kv_all[:, None], causal=True,
                              q_offset=q_offset, scale=scale)
        o = torch.einsum("bhlk,khv->bhlv", o_lat, w_uv)
    else:
        # naive form: expand the latent to per-head keys and values
        ukv = split_last(matmul(c_kv_all, rules.head_columns(
            params["w_ukv"].to(dt), hq)), (hq, nope + vd))
        k_nope = ukv[..., :nope].transpose(1, 2)            # (B, H, S, nope)
        v = ukv[..., nope:].transpose(1, 2)                 # (B, H, S, vd)
        k_rope_b = k_rope_all[:, None].expand(b, hq, k_rope_all.shape[1], rope)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope_b], dim=-1)
        q_full = shard_hint(q_full, BATCH_AXES, "model", None, None)
        k_full = shard_hint(k_full, BATCH_AXES, "model", None, None)
        v = shard_hint(v, BATCH_AXES, "model", None, None)
        o = ops.attention(q_full, k_full, v, causal=True, q_offset=q_offset,
                          scale=scale)
    o = shard_hint(o, BATCH_AXES, "model", None, None)
    out = matmul(o.transpose(1, 2).reshape(b, l, hq * vd), params["wo"].to(dt))
    return shard_hint(out, BATCH_AXES, None, None), new_cache


# -- cross attention (whisper decoder) -----------------------------------------
def cross_init(gen: torch.Generator, cfg, dtype, lead=()):
    """wq, wk, wv, wo; `lead` stacks them over layers."""
    d, hq, hd = cfg.d_model, cfg.num_heads, cfg.hd
    lead = tuple(lead)
    return {
        "wq": dense_init(gen, lead + (d, hq * hd), dtype, fan_in=d),
        "wk": dense_init(gen, lead + (d, hq * hd), dtype, fan_in=d),
        "wv": dense_init(gen, lead + (d, hq * hd), dtype, fan_in=d),
        "wo": dense_init(gen, lead + (hq * hd, d), dtype, fan_in=hq * hd),
    }


def cross_kv(params, cfg, enc: torch.Tensor):
    """The encoder's K/V (B, H, T, hd), computed once at prefill and reused
    every decode step (heads pinned to "model", batch to the data axes)."""
    hq, hd = cfg.num_heads, cfg.hd
    dt = enc.dtype

    def heads(w):
        x = split_last(matmul(enc, w.to(dt)), (hq, hd)).transpose(1, 2)
        return shard_hint(x, BATCH_AXES, "model", None, None)

    return heads(params["wk"]), heads(params["wv"])


def cross_apply(params, cfg, x: torch.Tensor,
                kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """The decoder's L queries over the encoder's T keys, non-causal."""
    b, l, d = x.shape
    hq, hd = cfg.num_heads, cfg.hd
    q = split_last(matmul(x, params["wq"].to(x.dtype)), (hq, hd)).transpose(1, 2)
    q = shard_hint(q, BATCH_AXES, "model", None, None)
    k, v = kv
    o = ops.attention(q, k, v, causal=False)
    o = shard_hint(o, BATCH_AXES, "model", None, None)
    out = matmul(o.transpose(1, 2).reshape(b, l, hq * hd),
                 params["wo"].to(x.dtype))
    return shard_hint(out, BATCH_AXES, None, None)


__all__ = ["KVCache", "MLACache", "cross_apply", "cross_init", "cross_kv",
           "gqa_apply", "gqa_cache_init", "gqa_init", "mla_apply",
           "mla_cache_init", "mla_init"]
