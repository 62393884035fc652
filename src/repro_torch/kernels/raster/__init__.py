"""Software rasteriser, PyTorch + CUDA: capsule scenes to framebuffers.

raster.py (the CUDA kernel's wrapper, sources in csrc/raster.cu), ref.py
(the plain PyTorch version), ops.py (backend dispatch).
"""
from repro_torch.kernels.raster.ops import (capsule_scene, rasterize,
                                           render_scene)
from repro_torch.kernels.raster.raster import rasterize_cuda
from repro_torch.kernels.raster.ref import rasterize_ref, tile_keep

__all__ = ["capsule_scene", "rasterize", "rasterize_cuda", "rasterize_ref",
           "render_scene", "tile_keep"]
