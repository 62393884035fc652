"""SSM / recurrent blocks: xLSTM (mLSTM + sLSTM) and Mamba2 (port of
`repro.models.ssm`).

All three expose (init, apply, cache_init, decode) with uniform signatures
so the stack treats them like attention blocks. Recurrent state is the
"KV cache" of these blocks, O(1) in sequence length, and f32 whatever the
model dtype (Mamba2's conv tail excepted: the model dtype). `apply` and
`decode` return a new state; the stack writes it into the cache it was
given (models/stack.py).

The JAX package's simplifications, kept:
  - mLSTM: exp input gate / sigmoid forget gate without the running-max
    stabiliser (gates ≤ 1 keep the chunked form stable); the normaliser
    rides in the GLA state as a ones-column of v.
  - Mamba2: a single B/C group (G=1), per-head scalar A.
  - sLSTM: exp forget-gate variant with the m_t stabiliser, block-diagonal
    recurrent weights per head, a post-MLP with the tanh GeLU
    (`jax.nn.gelu`'s default).

The sLSTM prefill is a Python loop over time steps, as the JAX package's
`lax.scan` (its input projection too, a product a step: one product over
the prompt rounds otherwise on the CPU, and 6 blocks carry that past the
tests' 1e-5).
Mamba2's causal depthwise conv is `F.conv1d` over the prompt with the cached
tail prepended (the JAX package gathers (B, L, W, C) windows).

On DTensors (models/lm.py's sharded paths) the JAX package's layout pins
stand where it puts them (mLSTM: the x and z projections, q, k and v;
Mamba2: q, k and v), the products are `rules.matmul`'s, and each block's
output is pinned to batch-sharded rows. Mamba2's input product is cut into
z | xBC | dt at unequal widths, which the "model" shards of `w_in` do not
follow: the product is gathered over "model" explicitly first (its
gradient comes back to the shards as the gather's backward gives it), so
that DTensor does not replicate the hidden dim in the backward. The sLSTM
runs on replicated heads, its whole loop one `local_map` over each rank's
rows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import is_dtensor
from repro_torch.models.gla import gla_chunked, gla_step
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.sharding.rules import BATCH_AXES, matmul, shard_hint, split_last

f32 = torch.float32


def _const(values, dtype, lead, device):
    """A constant vector stacked over `lead` layers, rounded to `dtype`."""
    x = values.to(device)
    return x.expand(tuple(lead) + x.shape).to(dtype).clone()


# ======================================================================= mLSTM
def mlstm_init(gen: torch.Generator, cfg, dtype, lead=()):
    d = cfg.d_model
    di = cfg.expand * d
    h = cfg.num_heads
    lead, dev = tuple(lead), gen.device
    return {
        "w_x": dense_init(gen, lead + (d, di), dtype, fan_in=d),
        "w_z": dense_init(gen, lead + (d, di), dtype, fan_in=d),
        "w_q": dense_init(gen, lead + (di, di), dtype, fan_in=di),
        "w_k": dense_init(gen, lead + (di, di), dtype, fan_in=di),
        "w_g": dense_init(gen, lead + (d, 2 * h), dtype, fan_in=d),  # [ĩ | f̃] per head
        "g_bias": _const(torch.cat([torch.full((h,), -3.0), torch.full((h,), 3.0)]),
                         dtype, lead, dev),
        "o_scale": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "w_down": dense_init(gen, lead + (di, d), dtype, fan_in=di),
    }


class MLSTMState(NamedTuple):
    s: torch.Tensor   # (B, H, K, V+1) matrix memory with normaliser column


def mlstm_cache_init(cfg, batch: int, dtype, device=None, lead=()) -> MLSTMState:
    di = cfg.expand * cfg.d_model
    h = cfg.num_heads
    return MLSTMState(torch.zeros(tuple(lead) + (batch, h, di // h, di // h + 1),
                                  dtype=f32, device=device))


def _mlstm_qkvg(params, cfg, x):
    b, l, d = x.shape
    di = cfg.expand * d
    h = cfg.num_heads
    hd = di // h
    dt = x.dtype
    xm = shard_hint(matmul(x, params["w_x"].to(dt)), BATCH_AXES, None, "model")
    z = shard_hint(matmul(x, params["w_z"].to(dt)), BATCH_AXES, None, "model")
    q = split_last(matmul(xm, params["w_q"].to(dt)), (h, hd)).transpose(1, 2) * (hd ** -0.5)
    k = split_last(matmul(xm, params["w_k"].to(dt)), (h, hd)).transpose(1, 2) * (hd ** -0.5)
    v = split_last(xm, (h, hd)).transpose(1, 2)
    q = shard_hint(q, BATCH_AXES, "model", None, None)
    k = shard_hint(k, BATCH_AXES, "model", None, None)
    v = shard_hint(v, BATCH_AXES, "model", None, None)
    gates = matmul(x, params["w_g"].to(dt)) + params["g_bias"].to(dt)
    i_pre, f_pre = torch.chunk(gates, 2, dim=-1)              # (B, L, H) each
    log_a = -F.softplus(-f_pre.to(f32)).transpose(1, 2)       # log σ(f̃) ≤ 0
    gate_b = torch.exp(torch.clamp_max(i_pre.to(f32), 0.0)).transpose(1, 2)  # ≤ 1
    # augment v with ones so the normaliser is carried in the state
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    return q, k, v_aug, log_a, gate_b, z


def _mlstm_out(params, cfg, y_aug, z, shape):
    b, l, d = shape
    di = cfg.expand * d
    y, n = y_aug[..., :-1], y_aug[..., -1:]
    h = (y / torch.clamp_min(n.abs(), 1.0)).transpose(1, 2).reshape(b, l, di)
    # pinned as z is: where the heads do not divide "model" (xLSTM's 4
    # over 16) h comes replicated, and its gradient must come back whole
    # before the reshape's backward cuts it into heads
    h = shard_hint(h, BATCH_AXES, None, "model")
    h = rms_norm(h, params["o_scale"], cfg.norm_eps)
    h = h * F.silu(z)
    return shard_hint(matmul(h, params["w_down"].to(h.dtype)), BATCH_AXES,
                      None, None)


def mlstm_apply(params, cfg, x, state: MLSTMState | None = None):
    """Prefill / forward. x: (B, L, d). Returns (out, new_state)."""
    q, k, v_aug, log_a, gate_b, z = _mlstm_qkvg(params, cfg, x)
    s0 = state.s if state is not None else torch.zeros(
        (x.shape[0], cfg.num_heads, q.shape[-1], v_aug.shape[-1]), dtype=f32,
        device=x.device)
    y, s = gla_chunked(q, k, v_aug, log_a, gate_b, s0, cfg.ssm_chunk)
    return _mlstm_out(params, cfg, y, z, x.shape), MLSTMState(s)


def mlstm_decode(params, cfg, x, state: MLSTMState):
    """x: (B, 1, d)."""
    q, k, v_aug, log_a, gate_b, z = _mlstm_qkvg(params, cfg, x)
    y, s = gla_step(q[:, :, 0], k[:, :, 0], v_aug[:, :, 0],
                    log_a[:, :, 0], gate_b[:, :, 0], state.s)
    return _mlstm_out(params, cfg, y[:, :, None], z, x.shape), MLSTMState(s)


# ======================================================================= sLSTM
def slstm_init(gen: torch.Generator, cfg, dtype, lead=()):
    d = cfg.d_model
    h = cfg.num_heads
    hd = d // h
    ff = max(4 * d // 3, 8)
    lead, dev = tuple(lead), gen.device
    return {
        "w": dense_init(gen, lead + (d, 4 * d), dtype, fan_in=d),      # x -> [i f z o]
        "r": dense_init(gen, lead + (h, hd, 4 * hd), dtype, fan_in=hd),  # block-diag
        "bias": _const(torch.cat([torch.full((d,), -3.0), torch.full((d,), 3.0),
                                  torch.zeros((2 * d,))]), dtype, lead, dev),
        # post-MLP (projection factor 4/3, GeLU)
        "mlp_in": dense_init(gen, lead + (d, ff), dtype, fan_in=d),
        "mlp_out": dense_init(gen, lead + (ff, d), dtype, fan_in=ff),
        "mlp_scale": torch.zeros(lead + (d,), dtype=dtype, device=dev),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, hd)
    n: torch.Tensor
    m: torch.Tensor   # (B, H, 1) stabiliser
    h: torch.Tensor   # (B, H, hd) previous hidden


def slstm_cache_init(cfg, batch: int, dtype, device=None, lead=()) -> SLSTMState:
    shape = tuple(lead) + (batch, cfg.num_heads, cfg.d_model // cfg.num_heads)
    z = lambda: torch.zeros(shape, dtype=f32, device=device)
    m = torch.full(shape[:-1] + (1,), -1e30, dtype=f32, device=device)
    return SLSTMState(z(), z(), m, z())


def _slstm_cell(params, xt, state: SLSTMState):
    """One time step of the stabilised exp-gate sLSTM; xt: (B, d)."""
    b, d = xt.shape
    hh = params["r"].shape[0]
    hd = d // hh
    pre = (xt @ params["w"].to(xt.dtype) + params["bias"].to(xt.dtype)).to(f32)
    pre = pre.reshape(b, 4, hh, hd).transpose(1, 2)          # (B, H, 4, hd)
    rec = torch.bmm(state.h.transpose(0, 1), params["r"].to(f32)).transpose(0, 1)
    pre = pre + rec.reshape(b, hh, 4, hd)
    i_pre, f_pre, z_pre, o_pre = pre.unbind(2)
    # stabiliser over per-head max (scalar per head keeps gates coupled)
    i_max = torch.amax(i_pre, dim=-1, keepdim=True)
    f_max = torch.amax(f_pre, dim=-1, keepdim=True)
    m_new = torch.maximum(f_max + state.m, i_max)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(f_pre + state.m - m_new)
    c = f_g * state.c + i_g * torch.tanh(z_pre)
    n = f_g * state.n + i_g
    h = torch.sigmoid(o_pre) * c / torch.clamp_min(n.abs(), 1e-6)
    return h, SLSTMState(c, n, m_new, h)


def _slstm_mlp(params, cfg, y):
    yn = rms_norm(y, params["mlp_scale"], cfg.norm_eps)
    hidden = F.gelu(matmul(yn, params["mlp_in"].to(y.dtype)),
                    approximate="tanh")
    return shard_hint(y + matmul(hidden, params["mlp_out"].to(y.dtype)),
                      BATCH_AXES, None, None)


def _slstm_scan(params, x, state: SLSTMState):
    """The cell over x's time steps (B, L, d): (h (B, L, d) in x's dtype,
    the last state)."""
    b, l, d = x.shape
    hs = []
    for t in range(l):
        h, state = _slstm_cell(params, x[:, t], state)
        hs.append(h)
    return torch.stack(hs, dim=1).reshape(b, l, d).to(x.dtype), state


def _slstm_sharded(params, x, state: SLSTMState):
    """`_slstm_scan` on each rank's rows of DTensors (one `local_map` over
    the whole loop: a step's ops on local tensors, not a DTensor dispatch
    each): x and the state batch-sharded where x is, the heads replicated
    (the state pinned so: a cache may shard them over "model"), the cell's
    weights whole (their FSDP shards gathered), their gradients partial
    sums over the mesh dims that split the rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.rules import gathered, placed

    mesh = x.device_mesh
    xp = [Shard(0) if p == Shard(0) else Replicate() for p in x.placements]
    wp = [Replicate()] * mesh.ndim
    wg = [Partial() if p == Shard(0) else Replicate() for p in xp]
    names = ("w", "r", "bias")

    def body(xl, c, n, m, h, *ws):
        return _slstm_scan(dict(zip(names, ws)), xl, SLSTMState(c, n, m, h))

    return local_map(
        body, out_placements=(xp,) * 5, in_placements=(xp,) * 5 + (wp,) * 3,
        in_grad_placements=(xp,) * 5 + (wg,) * 3, device_mesh=mesh)(
        placed(x, xp), *(placed(v, xp, mesh) for v in state),
        *(placed(gathered(params[k]), wp, mesh) for k in names))


def slstm_apply(params, cfg, x, state: SLSTMState | None = None):
    b, l, d = x.shape
    if state is None:
        state = slstm_cache_init(cfg, b, x.dtype, x.device)
    scan = _slstm_sharded if is_dtensor(x) else _slstm_scan
    y, state = scan(params, x, state)
    return _slstm_mlp(params, cfg, y), state


def slstm_decode(params, cfg, x, state: SLSTMState):
    b, _, d = x.shape
    if is_dtensor(x):
        y, state = _slstm_sharded(params, x, state)
        return _slstm_mlp(params, cfg, y), state
    h, state = _slstm_cell(params, x[:, 0], state)
    y = h.reshape(b, 1, d).to(x.dtype)
    return _slstm_mlp(params, cfg, y), state


# ====================================================================== Mamba2
def mamba2_init(gen: torch.Generator, cfg, dtype, lead=()):
    d = cfg.d_model
    di = cfg.expand * d
    h = cfg.num_heads
    n = cfg.ssm_state
    conv_ch = di + 2 * n
    lead, dev = tuple(lead), gen.device
    conv_w = torch.randn(lead + (cfg.conv_width, conv_ch), generator=gen, device=dev)
    return {
        "w_in": dense_init(gen, lead + (d, 2 * di + 2 * n + h), dtype, fan_in=d),  # [z|x|B|C|dt]
        "conv_w": conv_w.mul_(0.1).to(dtype),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=dev),
        "a_log": _const(torch.log(torch.arange(1, h + 1, dtype=f32)), dtype, lead, dev),
        "dt_bias": torch.zeros(lead + (h,), dtype=dtype, device=dev),
        "d_skip": torch.ones(lead + (h,), dtype=dtype, device=dev),
        "o_scale": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "w_out": dense_init(gen, lead + (di, d), dtype, fan_in=di),
    }


class Mamba2State(NamedTuple):
    s: torch.Tensor      # (B, H, N, P) SSD state
    conv: torch.Tensor   # (B, W-1, di+2N) conv tail


def mamba2_cache_init(cfg, batch: int, dtype, device=None, lead=()) -> Mamba2State:
    di = cfg.expand * cfg.d_model
    h, n = cfg.num_heads, cfg.ssm_state
    lead = tuple(lead)
    return Mamba2State(
        torch.zeros(lead + (batch, h, n, di // h), dtype=f32, device=device),
        torch.zeros(lead + (batch, cfg.conv_width - 1, di + 2 * n), dtype=dtype,
                    device=device))


def _mamba2_proj(params, cfg, x):
    di = cfg.expand * cfg.d_model
    n, h = cfg.ssm_state, cfg.num_heads
    # z | xBC | dt cut at unequal widths: gathered over "model" first
    zxbcdt = shard_hint(matmul(x, params["w_in"].to(x.dtype)), BATCH_AXES,
                        None, None)
    return zxbcdt[..., :di], zxbcdt[..., di: 2 * di + 2 * n], zxbcdt[..., -h:]


def _mamba2_ssd_inputs(params, cfg, xbc, dt_pre, b, l):
    di = cfg.expand * cfg.d_model
    n, h = cfg.ssm_state, cfg.num_heads
    p = di // h
    xs = F.silu(xbc[..., :di])
    bs = F.silu(xbc[..., di: di + n])
    cs = F.silu(xbc[..., di + n:])
    dt = F.softplus(dt_pre.to(f32) + params["dt_bias"].to(f32))        # (B, L, H)
    a = -torch.exp(params["a_log"].to(f32))                              # (H,)
    log_a = (a[None, None] * dt).transpose(1, 2)                         # (B, H, L) <= 0
    gate_b = dt.transpose(1, 2)                                          # (B, H, L)
    v = xs.reshape(b, l, h, p).transpose(1, 2)                           # (B, H, L, P)
    k = bs[:, None].expand(b, h, l, n)           # shared across heads (G=1)
    q = cs[:, None].expand(b, h, l, n)
    v = shard_hint(v, BATCH_AXES, "model", None, None)
    k = shard_hint(k, BATCH_AXES, "model", None, None)
    q = shard_hint(q, BATCH_AXES, "model", None, None)
    return q, k, v, log_a, gate_b, xs


def _mamba2_out(params, cfg, y, xs, z, shape):
    b, l, d = shape
    di = cfg.expand * d
    h = cfg.num_heads
    y = y + params["d_skip"].to(f32)[None, :, None, None] * \
        xs.reshape(b, l, h, di // h).transpose(1, 2)
    y = y.transpose(1, 2).reshape(b, l, di).to(z.dtype)
    y = rms_norm(y * F.silu(z), params["o_scale"], cfg.norm_eps)
    return shard_hint(matmul(y, params["w_out"].to(y.dtype)), BATCH_AXES,
                      None, None)


def _conv(padded, conv_w, conv_b):
    """The depthwise causal conv of (B, L+W-1, C) windows: (B, L, C)."""
    weight = conv_w.t().unsqueeze(1)                          # (C, 1, W)
    return F.conv1d(padded.transpose(1, 2), weight,
                    groups=padded.shape[-1]).transpose(1, 2) + conv_b


def _causal_conv(padded, conv_w, conv_b):
    """`_conv`; on DTensors each rank's rows (`local_map`: every row and
    channel is independent; DTensor's own convolution handler takes the
    sequence for a sharded dim), the weights whole, their gradients partial
    sums over the mesh dims that split the rows."""
    if not is_dtensor(padded):
        return _conv(padded, conv_w, conv_b)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.rules import placed

    mesh = padded.device_mesh
    xp = [Shard(0) if p == Shard(0) else Replicate() for p in padded.placements]
    wp = [Replicate()] * mesh.ndim
    wg = [Partial() if p == Shard(0) else Replicate() for p in xp]
    return local_map(_conv, out_placements=xp, in_placements=(xp, wp, wp),
                     in_grad_placements=(xp, wg, wg), device_mesh=mesh)(
        placed(padded, xp), placed(conv_w, wp, mesh), placed(conv_b, wp, mesh))


def mamba2_apply(params, cfg, x, state: Mamba2State | None = None):
    b, l, d = x.shape
    z, xbc, dt_pre = _mamba2_proj(params, cfg, x)
    # causal depthwise conv (width W); the cached tail prepended
    w, ch = cfg.conv_width, xbc.shape[-1]
    tail = state.conv if state is not None else torch.zeros(
        (b, w - 1, ch), dtype=xbc.dtype, device=x.device)
    padded = torch.cat([tail.to(xbc.dtype), xbc], dim=1)      # (B, L+W-1, C)
    xbc_conv = _causal_conv(padded, params["conv_w"].to(xbc.dtype),
                            params["conv_b"].to(xbc.dtype))
    new_tail = padded[:, l:]                                  # last W-1 entries

    q, k, v, log_a, gate_b, xs = _mamba2_ssd_inputs(params, cfg, xbc_conv, dt_pre, b, l)
    s0 = state.s if state is not None else torch.zeros(
        (b, cfg.num_heads, cfg.ssm_state, v.shape[-1]), dtype=f32, device=x.device)
    y, s = gla_chunked(q, k, v, log_a, gate_b, s0, cfg.ssm_chunk)
    out = _mamba2_out(params, cfg, y, xs, z, x.shape)
    return out, Mamba2State(s, new_tail)


def mamba2_decode(params, cfg, x, state: Mamba2State):
    b, _, d = x.shape
    z, xbc, dt_pre = _mamba2_proj(params, cfg, x)
    window = torch.cat([state.conv.to(xbc.dtype), xbc], dim=1)  # (B, W, C)
    xbc_conv = torch.einsum("bwc,wc->bc", window,
                            params["conv_w"].to(xbc.dtype))[:, None] \
        + params["conv_b"].to(xbc.dtype)
    new_tail = window[:, 1:]
    q, k, v, log_a, gate_b, xs = _mamba2_ssd_inputs(params, cfg, xbc_conv, dt_pre, b, 1)
    y, s = gla_step(q[:, :, 0], k[:, :, 0], v[:, :, 0], log_a[:, :, 0],
                    gate_b[:, :, 0], state.s)
    out = _mamba2_out(params, cfg, y[:, :, None], xs, z, x.shape)
    return out, Mamba2State(s, new_tail)


__all__ = ["MLSTMState", "Mamba2State", "SLSTMState", "mamba2_apply",
           "mamba2_cache_init", "mamba2_decode", "mamba2_init", "mlstm_apply",
           "mlstm_cache_init", "mlstm_decode", "mlstm_init", "slstm_apply",
           "slstm_cache_init", "slstm_decode", "slstm_init"]
