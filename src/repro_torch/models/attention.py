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
are given. The JAX package's `shard_hint` layout pins have no meaning on
one card and are dropped.

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

from repro_torch.kernels.attention import ops
from repro_torch.models.layers import apply_rope, dense_init, rms_norm

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


def _slot_attention(q, ck, cv, valid, hkv):
    """One-token attention over every cache slot under a (.., S) `valid`
    mask that broadcasts to (B, Hq, L, S): the JAX package's einsum and
    softmax, in f32."""
    b, hq, l, hd = q.shape
    s_max = ck.shape[2]
    s = torch.matmul(q.reshape(b, hkv, hq // hkv * l, hd).float(),
                     ck.float().transpose(-1, -2)) * (hd ** -0.5)
    s = s.reshape(b, hq, l, s_max).masked_fill(~valid, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.reshape(b, hkv, -1, s_max),
                        cv.float()).reshape(b, hq, l, hd).to(q.dtype)


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
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    b, l, d = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = x.dtype
    positions = positions if positions is not None else torch.arange(l, device=x.device)
    per_slot = (cache is not None and isinstance(cache_pos, torch.Tensor)
                and cache_pos.dim() == 1)

    q = (x @ params["wq"].to(dt)).reshape(b, l, hq, hd)
    k = (x @ params["wk"].to(dt)).reshape(b, l, hkv, hd)
    v = (x @ params["wv"].to(dt)).reshape(b, l, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_scale"], cfg.norm_eps)
        k = rms_norm(k, params["k_scale"], cfg.norm_eps)
    rope_pos = cache_pos[:, None, None] if per_slot else positions  # (B,1,1) or (L,)
    q = apply_rope(q.transpose(1, 2), rope_pos, cfg.rope_theta)    # (B, Hq, L, hd)
    k = apply_rope(k.transpose(1, 2), rope_pos, cfg.rope_theta)    # (B, Hkv, L, hd)
    v = v.transpose(1, 2)

    new_cache = None
    if cache is not None:
        ck, cv = cache.k, cache.v
        s_max = ck.shape[2]
        ring = window > 0 and s_max == window
        if per_slot:
            # one-token decode with heterogeneous per-slot positions
            slot = (cache_pos % s_max) if ring else cache_pos
            bi = torch.arange(b, device=x.device)
            ck[bi, :, slot] = k[:, :, 0].to(ck.dtype)
            cv[bi, :, slot] = v[:, :, 0].to(cv.dtype)
        elif ring:
            # Ring cache: keep only the last `window` positions.
            take = min(l, s_max)
            slots = (cache_pos + l - take + torch.arange(take, device=x.device)) % s_max
            ck[:, :, slots] = k[:, :, l - take:].to(ck.dtype)
            cv[:, :, slots] = v[:, :, l - take:].to(cv.dtype)
        else:
            # dynamic_update_slice semantics: the start clamps so that the
            # L new positions fit
            start = min(max(int(cache_pos), 0), s_max - l)
            ck[:, :, start:start + l] = k.to(ck.dtype)
            cv[:, :, start:start + l] = v.to(cv.dtype)
        new_cache = KVCache(ck, cv)
        if per_slot:
            # attend over slots valid for each batch row
            kpos_ring = torch.arange(s_max, device=x.device)
            if ring:
                base = (cache_pos // s_max)[:, None] * s_max
                abs_pos = kpos_ring[None, :] + base
                abs_pos = torch.where(kpos_ring[None, :] > (cache_pos % s_max)[:, None],
                                      abs_pos - s_max, abs_pos)
                valid = (abs_pos <= cache_pos[:, None]) & \
                        (abs_pos > (cache_pos - window)[:, None]) & (abs_pos >= 0)
            else:
                valid = kpos_ring[None, :] <= cache_pos[:, None]
                if window > 0:
                    valid &= kpos_ring[None, :] > (cache_pos - window)[:, None]
            o = _slot_attention(q, ck, cv, valid[:, None, None, :], hkv)
        elif ring and l > 1:
            # SWA prefill (single-shot, cache_pos == 0): attend over the local
            # window of the fresh k/v directly; the ring holds the tail.
            o = ops.attention(q, k, v, causal=True, window=window)
        elif ring:
            # SWA decode: attend over ring slots with ring-aware positions.
            kpos_ring = torch.arange(s_max, device=x.device)
            slot = cache_pos % s_max
            abs_pos = kpos_ring + (cache_pos // s_max) * s_max
            abs_pos = torch.where(kpos_ring > slot, abs_pos - s_max, abs_pos)
            valid = (abs_pos <= cache_pos) & (abs_pos > cache_pos - window) & (abs_pos >= 0)
            o = _slot_attention(q, ck, cv, valid, hkv)
        else:
            # causal w.r.t. absolute positions: kpos <= qpos also masks the
            # not-yet-written tail of the cache (all written slots < pos+l).
            o = ops.attention(q, ck, cv, causal=True, window=window,
                              q_offset=int(cache_pos))
    else:
        o = ops.attention(q, k, v, causal=causal, window=window)

    out = o.transpose(1, 2).reshape(b, l, hq * hd) @ params["wo"].to(dt)
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
    cq = rms_norm(x @ params["w_dq"].to(dt), params["q_scale"], cfg.norm_eps)
    q = (cq @ params["w_uq"].to(dt)).reshape(b, l, hq, nope + rope)
    q_rope = apply_rope(q[..., nope:].transpose(1, 2), positions, cfg.rope_theta)  # (B,H,L,rope)
    q_nope = q[..., :nope].transpose(1, 2)

    # compressed kv latent + shared rotary key
    dkv = x @ params["w_dkv"].to(dt)                        # (B, L, kvr + rope)
    c_kv = rms_norm(dkv[..., :kvr], params["kv_scale"], cfg.norm_eps)
    k_rope_new = apply_rope(dkv[..., kvr:][:, None], positions, cfg.rope_theta)[:, 0]

    new_cache = None
    if cache is not None:
        # dynamic_update_slice semantics: the start clamps so that the L new
        # positions fit
        s_max = cache.c_kv.shape[1]
        start = min(max(int(cache_pos), 0), s_max - l)
        cache.c_kv[:, start:start + l] = c_kv.to(cache.c_kv.dtype)
        cache.k_rope[:, start:start + l] = k_rope_new.to(cache.k_rope.dtype)
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
        w_ukv = params["w_ukv"].to(dt).reshape(kvr, hq, nope + vd)
        w_uk, w_uv = w_ukv[..., :nope], w_ukv[..., nope:]   # (kvr, H, nope), (kvr, H, vd)
        q_lat = torch.einsum("bhln,khn->bhlk", q_nope, w_uk)
        q_eff = torch.cat([q_lat, q_rope], dim=-1)          # (B, H, L, kvr + rope)
        k_eff = torch.cat([c_kv_all, k_rope_all.to(c_kv_all.dtype)],
                          dim=-1)[:, None]                  # (B, 1, S, kvr + rope)
        o_lat = ops.attention(q_eff, k_eff, c_kv_all[:, None], causal=True,
                              q_offset=q_offset, scale=scale)
        o = torch.einsum("bhlk,khv->bhlv", o_lat, w_uv)
    else:
        # naive form: expand the latent to per-head keys and values
        ukv = (c_kv_all @ params["w_ukv"].to(dt)).reshape(b, -1, hq, nope + vd)
        k_nope = ukv[..., :nope].transpose(1, 2)            # (B, H, S, nope)
        v = ukv[..., nope:].transpose(1, 2)                 # (B, H, S, vd)
        k_rope_b = k_rope_all[:, None].expand(b, hq, k_rope_all.shape[1], rope)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope_b], dim=-1)
        o = ops.attention(q_full, k_full, v, causal=True, q_offset=q_offset,
                          scale=scale)
    out = o.transpose(1, 2).reshape(b, l, hq * vd) @ params["wo"].to(dt)
    return out, new_cache


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
    every decode step."""
    b, t, d = enc.shape
    hq, hd = cfg.num_heads, cfg.hd
    k = (enc @ params["wk"].to(enc.dtype)).reshape(b, t, hq, hd).transpose(1, 2)
    v = (enc @ params["wv"].to(enc.dtype)).reshape(b, t, hq, hd).transpose(1, 2)
    return k, v


def cross_apply(params, cfg, x: torch.Tensor,
                kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """The decoder's L queries over the encoder's T keys, non-causal."""
    b, l, d = x.shape
    hq, hd = cfg.num_heads, cfg.hd
    q = (x @ params["wq"].to(x.dtype)).reshape(b, l, hq, hd).transpose(1, 2)
    k, v = kv
    o = ops.attention(q, k, v, causal=False)
    return o.transpose(1, 2).reshape(b, l, hq * hd) @ params["wo"].to(x.dtype)


__all__ = ["KVCache", "MLACache", "cross_apply", "cross_init", "cross_kv",
           "gqa_apply", "gqa_cache_init", "gqa_init", "mla_apply",
           "mla_cache_init", "mla_init"]
