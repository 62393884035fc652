"""CUDA rasteriser: capsule scenes to framebuffers, one launch per batch.

The port of the Pallas TPU kernel
`src/repro/kernels/raster/raster.py::rasterize_pallas`. The kernel itself is
hand-written CUDA C++ for sm_90a in `csrc/raster.cu` (design and bound in
its header); this module is its wrapper: it checks the operands, allocates
the output, launches on PyTorch's current stream and counts the launches.
It takes only CUDA tensors and raises on anything else; the plain version
for the CPU is `ref.rasterize_ref`, chosen by `ops.rasterize`.
"""
from __future__ import annotations

import ctypes

import torch


def _bind(lib: ctypes.CDLL):
    """lib's C entry point `rasterize`, typed."""
    fn = lib.rasterize
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    return fn


def _library():
    from repro_torch.kernels.build import load

    return _bind(load("raster"))


def rasterize_cuda(segs: torch.Tensor, intens: torch.Tensor, h: int,
                   w: int) -> torch.Tensor:
    """segs (N, S, 5) and intens (N, S), contiguous float32 on one CUDA
    device -> (N, H, W) float32 framebuffers, as one CUDA launch."""
    for what, x in (("segs", segs), ("intens", intens)):
        if not x.is_cuda:
            raise ValueError(f"rasterize_cuda takes CUDA tensors; {what} is "
                             f"on {x.device}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"rasterize_cuda takes contiguous float32; {what}"
                             f" is {x.dtype}, contiguous={x.is_contiguous()}")
    if intens.device != segs.device:
        raise ValueError(f"intens is on {intens.device}, segs on {segs.device}")
    if segs.dim() != 3 or segs.shape[-1] != 5 or (
            tuple(intens.shape) != tuple(segs.shape[:2])):
        raise ValueError(f"rasterize_cuda takes segs (N, S, 5) and intens "
                         f"(N, S); got {tuple(segs.shape)}, "
                         f"{tuple(intens.shape)}")
    n, s, _ = segs.shape
    if min(n, s, h, w) < 1:
        raise ValueError(f"rasterize_cuda needs N, S, H, W >= 1; got {n}, "
                         f"{s}, {h}, {w}")
    out = torch.empty((n, h, w), dtype=torch.float32, device=segs.device)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    rc = _library()(n, s, int(h), int(w), ptr(segs), ptr(intens), ptr(out),
                    ctypes.c_void_p(
                        torch.cuda.current_stream(segs.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"raster kernel launch failed: cudaError {rc}")
    rasterize_cuda.launches += 1
    return out


#: kernel launches since the count was last set to 0 (chip_smoke.py reads it)
rasterize_cuda.launches = 0

__all__ = ["rasterize_cuda"]
