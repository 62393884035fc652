"""Public rasteriser API with backend dispatch (port of
`repro.kernels.raster.ops`).

"cuda" launches the kernel, "torch" runs the plain version, "auto" picks
the kernel for CUDA tensors and the plain version for CPU tensors. Nothing
falls back: a CUDA tensor given to "cuda" or "auto" launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.raster.raster import rasterize_cuda
from repro_torch.kernels.raster.ref import rasterize_ref

BACKENDS = ("auto", "cuda", "torch")


def rasterize(segs: torch.Tensor, intens: torch.Tensor, h: int, w: int,
              backend: str = "auto") -> torch.Tensor:
    """Render (N, S, 5) capsule scenes to (N, H, W) float32 framebuffers."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "cuda" or (backend == "auto" and segs.is_cuda):
        return rasterize_cuda(segs.to(torch.float32).contiguous(),
                              intens.to(torch.float32).contiguous(), h, w)
    return rasterize_ref(segs, intens, h, w)


def capsule_scene(like: torch.Tensor, segments, intens):
    """Stack a scene from per-lane tensors and constants.

    `segments` is S rows of 5 entries `[x0, y0, x1, y1, r]`, `intens` S
    entries; each entry is a tensor that broadcasts to `like`'s shape or a
    Python number, filled on `like`'s device (no host copy). Returns
    (..., S, 5) and (..., S) float32, `...` being `like`'s shape.
    """
    val = lambda v: (v.expand(like.shape) if isinstance(v, torch.Tensor)
                     else torch.full_like(like, v))
    segs = torch.stack([torch.stack([val(v) for v in row], -1)
                        for row in segments], -2)
    return segs, torch.stack([val(v) for v in intens], -1)


def render_scene(segs: torch.Tensor, intens: torch.Tensor, h: int, w: int,
                 backend: str = "auto") -> torch.Tensor:
    """Scenes with any leading axes: (..., S, 5), (..., S) -> (..., H, W),
    as one batched `rasterize` call. What a batch-native env's `render`
    runs."""
    lead = segs.shape[:-2]
    frames = rasterize(segs.reshape((-1,) + tuple(segs.shape[-2:])),
                       intens.reshape(-1, intens.shape[-1]), h, w, backend)
    return frames.reshape(lead + (h, w))


__all__ = ["BACKENDS", "capsule_scene", "rasterize", "render_scene"]
