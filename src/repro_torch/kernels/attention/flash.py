"""CUDA flash attention: online-softmax GQA attention, one launch a call.

The port of the Pallas TPU kernel
`src/repro/kernels/attention/flash.py::flash_attention`, widened to the
contract of `ref.attention_ref` (a `q_offset`, any Lq and Lk), which is what
`models/attention.py::_attend_chunked` asks of it. The kernels themselves
are hand-written CUDA C++ for sm_90a in `csrc/flash.cu` (design and bound in
its header): bfloat16 runs on the tensor cores, float32 on the CUDA cores.
This module is their one wrapper: it checks the operands, allocates the
output (and, asked for, each row's log-sum-exp), launches on PyTorch's
current stream and counts the launches.
It takes only CUDA tensors and raises on anything else; the plain version
for the CPU is `ref.attention_ref`, chosen by `ops.attention`.
"""
from __future__ import annotations

import ctypes

import torch

#: (D, Dv) head-dim pairs the kernels are instantiated for: D = Dv for the
#: GQA models (Yi 128, Danube 80, the tests'), (96, 64) for MLA's naive form
#: (MiniCPM3-4B: q and k of nope + rope, v of v_head_dim) and (288, 256) for
#: its absorbed form (q and k of kv_lora_rank + rope, v of kv_lora_rank, one
#: KV head: its tiles take every query head of the KV head together)
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (80, 80), (128, 128), (96, 64),
             (288, 256))
#: dtype codes of the C interface
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL):
    """lib's C entry point `flash_attention`, typed."""
    fn = lib.flash_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 11 + [ctypes.c_float]
                       + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
    return fn


def _library():
    from repro_torch.kernels.build import load

    return _bind(load("flash"))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         q_offset: int = 0,
                         scale: float | None = None,
                         return_lse: bool = False):
    """q (B, Hq, Lq, D), k (B, Hkv, Lk, D) and v (B, Hkv, Lk, Dv),
    contiguous float32 or bfloat16 on one CUDA device, 16-byte aligned, Hq a
    multiple of Hkv -> (B, Hq, Lq, Dv) in q's dtype, as one CUDA launch.
    Query row i sits at absolute position q_offset + i; key j is visible
    where j <= q_offset + i (causal) and j > q_offset + i - window (window
    > 0; q_offset may be negative: a launch over a later range of keys).
    `scale` defaults to D ** -0.5. With `return_lse`, (out, lse): lse is
    float32 (B, Hq, Lq), each row's log-sum-exp of its visible scaled
    scores (-inf where it sees none; its output row is then 0), written by
    the same launch, which computes the same output either way. A (D, Dv)
    pair the kernels are not built for (`HEAD_DIMS`) raises
    NotImplementedError: nothing runs the plain version in its place."""
    from repro_torch.kernels import is_dtensor

    for x in (q, k, v):
        if is_dtensor(x):
            # ops.attention runs the kernel on each rank's shard; nothing
            # gathers a DTensor whole for it
            raise TypeError(f"flash_attention_cuda takes one device's "
                            f"tensors; got a DTensor ({x.placements})")
    # shapes and head dims first: a pair the kernels are not built for is
    # refused as such on any device
    if not all(x.dim() == 4 for x in (q, k, v)):
        raise ValueError(f"flash_attention_cuda takes 4-D q, k and v; got "
                         f"{q.dim()}-, {k.dim()}- and {v.dim()}-D")
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    dv = v.shape[3]
    if (k.shape[0] != b or k.shape[3] != d or tuple(v.shape[:3]) != tuple(k.shape[:3])
            or hkv < 1 or hq % hkv):
        raise ValueError(f"flash_attention_cuda takes q (B, Hq, Lq, D), k "
                         f"(B, Hkv, Lk, D) and v (B, Hkv, Lk, Dv) with Hq % Hkv "
                         f"== 0; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if (d, dv) not in HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention_cuda is built for (D, Dv) in {HEAD_DIMS}; got "
            f"({d}, {dv}). ops.attention zero-pads a smaller pair up to a "
            f"built one; a pair above 128 needs an instantiation of its own "
            f"in csrc/flash.cu")
    for what, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"flash_attention_cuda takes CUDA tensors; {what}"
                             f" is on {x.device}")
        if x.dtype not in DTYPES or x.dtype != q.dtype or not x.is_contiguous():
            raise ValueError(
                f"flash_attention_cuda takes contiguous float32 or bfloat16 "
                f"of one dtype; {what} is {x.dtype} (q {q.dtype}), "
                f"contiguous={x.is_contiguous()}")
        if x.device != q.device:
            raise ValueError(f"{what} is on {x.device}; q is on {q.device}")
    if min(b, hq, lq, lk) < 1 or max(lq, lk, abs(q_offset), abs(window)) >= 2**30:
        raise ValueError(f"flash_attention_cuda needs B, Hq, Lq, Lk >= 1 and "
                         f"lengths, q_offset and window below 2**30; got "
                         f"{b}, {hq}, {lq}, {lk}, {q_offset}, {window}")
    scale = (d ** -0.5) if scale is None else scale
    out = q.new_empty((b, hq, lq, dv))
    lse = (torch.empty((b, hq, lq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    for what, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda takes 16-byte aligned "
                             f"tensors; {what} is at {x.data_ptr():#x}")
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    rc = _library()(DTYPES[q.dtype], b, hq, hkv, lq, lk, d, dv, int(bool(causal)),
                    int(window), int(q_offset), float(scale), ptr(q),
                    ptr(k), ptr(v), ptr(out),
                    None if lse is None else ptr(lse), ctypes.c_void_p(
                        torch.cuda.current_stream(q.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {rc}")
    flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


#: kernel launches since the count was last set to 0 (chip_smoke.py reads it)
flash_attention_cuda.launches = 0


def cost(b: int, heads, lq: int, lk: int, causal: bool = True,
         window: int = 0, q_offset: int = 0, itemsize: int = 2) -> dict:
    """What one launch must move and do: `heads` (Hq, Hkv, D, Dv), every
    query row's visible keys counted (causal, window and q_offset as the
    kernel masks them). Bytes: Q read and O written once (D + Dv a query
    row), the live K and V read once per KV head; flops: 2·(D + Dv) a live
    query-key pair (q·k and p·v)."""
    hq, hkv, d, dv = heads
    live_pairs, lo_min, hi_max = 0, lk, 0
    for i in range(lq):
        qpos = q_offset + i
        hi = min(lk, qpos + 1) if causal else lk
        lo = max(0, qpos - window + 1) if window > 0 else 0
        live_pairs += max(hi - lo, 0)
        lo_min, hi_max = min(lo_min, lo), max(hi_max, hi)
    live_keys = max(0, hi_max - lo_min)
    return {"live_pairs": live_pairs * b * hq,
            "bytes": itemsize * (d + dv) * b * (hq * lq + hkv * live_keys),
            "flops": 2 * (d + dv) * live_pairs * b * hq}

__all__ = ["DTYPES", "HEAD_DIMS", "cost", "flash_attention_cuda"]
