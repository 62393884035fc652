"""CUDA flash attention: online-softmax GQA attention, one launch a call.

The port of the Pallas TPU kernel
`src/repro/kernels/attention/flash.py::flash_attention`, widened to the
contract of `ref.attention_ref` (a `q_offset`, any Lq and Lk), which is what
`models/attention.py::_attend_chunked` asks of it. The kernels themselves
are hand-written CUDA C++ for sm_90a in `csrc/flash.cu` (design and bound in
its header): bfloat16 runs on the tensor cores, float32 on the CUDA cores.
This module is their one wrapper: it checks the operands, allocates the
output, launches on PyTorch's current stream and counts the launches.
It takes only CUDA tensors and raises on anything else; the plain version
for the CPU is `ref.attention_ref`, chosen by `ops.attention`.
"""
from __future__ import annotations

import ctypes

import torch

#: head dims the kernel is instantiated for (Yi 128, Danube 80, the tests')
HEAD_DIMS = (16, 32, 64, 80, 128)
#: dtype codes of the C interface
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL):
    """lib's C entry point `flash_attention`, typed."""
    fn = lib.flash_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 10 + [ctypes.c_float]
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
    return fn


def _library():
    from repro_torch.kernels.build import load

    return _bind(load("flash"))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         q_offset: int = 0,
                         scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Lq, D), k and v (B, Hkv, Lk, D), contiguous float32 or
    bfloat16 on one CUDA device, 16-byte aligned, Hq a multiple of Hkv ->
    (B, Hq, Lq, D) in q's dtype, as one CUDA launch. Query row i sits at
    absolute position q_offset + i; key j is visible where j <= q_offset + i
    (causal) and j > q_offset + i - window (window > 0)."""
    for what, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"flash_attention_cuda takes CUDA tensors; {what}"
                             f" is on {x.device}")
        if x.dtype not in DTYPES or x.dtype != q.dtype or not x.is_contiguous():
            raise ValueError(
                f"flash_attention_cuda takes contiguous float32 or bfloat16 "
                f"of one dtype; {what} is {x.dtype} (q {q.dtype}), "
                f"contiguous={x.is_contiguous()}")
        if x.device != q.device or x.dim() != 4:
            raise ValueError(f"{what} is {x.dim()}-D on {x.device}; q is "
                             f"4-D on {q.device}")
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    if (k.shape[0] != b or k.shape[3] != d or tuple(v.shape) != tuple(k.shape)
            or hkv < 1 or hq % hkv):
        raise ValueError(f"flash_attention_cuda takes q (B, Hq, Lq, D), k and "
                         f"v (B, Hkv, Lk, D) with Hq % Hkv == 0; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda is built for head dims "
                         f"{HEAD_DIMS}; got {d}")
    if min(b, hq, lq, lk) < 1 or max(lq, lk, abs(q_offset), abs(window)) >= 2**30:
        raise ValueError(f"flash_attention_cuda needs B, Hq, Lq, Lk >= 1 and "
                         f"lengths, q_offset and window below 2**30; got "
                         f"{b}, {hq}, {lq}, {lk}, {q_offset}, {window}")
    scale = (d ** -0.5) if scale is None else scale
    out = torch.empty_like(q)
    for what, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda takes 16-byte aligned "
                             f"tensors; {what} is at {x.data_ptr():#x}")
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    rc = _library()(DTYPES[q.dtype], b, hq, hkv, lq, lk, d, int(bool(causal)),
                    int(window), int(q_offset), float(scale), ptr(q),
                    ptr(k), ptr(v), ptr(out), ctypes.c_void_p(
                        torch.cuda.current_stream(q.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {rc}")
    flash_attention_cuda.launches += 1
    return out


#: kernel launches since the count was last set to 0 (chip_smoke.py reads it)
flash_attention_cuda.launches = 0

__all__ = ["DTYPES", "HEAD_DIMS", "flash_attention_cuda"]
