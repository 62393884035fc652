"""Plain PyTorch software rasteriser: the CUDA kernel's reference (port of
`repro.kernels.raster.ref`).

Scene model: each frame is a set of S capsules (line segments with a
radius; rectangles, rods and dots are all capsules) with coordinates in
[0, 1]², x rightward and y downward. A pixel is the max over segments of a
one-pixel soft edge times the segment's intensity; zero-intensity segments
are inert padding.

Written op by op in the JAX oracle's order, each op rounded on its own:
`x*x` for `**2`, divisions by Python numbers through `numerics.div` (an
IEEE division on every device), the square root correctly rounded, and
`softness = 1/h` computed in double as JAX computes it and rounded to
float32 once. The segment loop keeps a
running max, so memory stays O(N·H·W) whatever S is. The CPU path of every
render, and what csrc/raster.cu is held against on the card
(chip_smoke.py).
"""
from __future__ import annotations

import torch

from repro_torch.numerics import div

_EPS = 1e-8


def _pixel_grid(h: int, w: int, device):
    """Pixel-centre coordinates: px (1, W), py (H, 1)."""
    f32 = torch.float32
    py = div(torch.arange(h, dtype=f32, device=device) + 0.5, h)[:, None]
    px = div(torch.arange(w, dtype=f32, device=device) + 0.5, w)[None, :]
    return px, py


def rasterize_ref(segs: torch.Tensor, intens: torch.Tensor, h: int,
                  w: int) -> torch.Tensor:
    """segs (N, S, 5) `[x0, y0, x1, y1, radius]`, intens (N, S) -> (N, H, W)
    float32 framebuffers."""
    segs = segs.to(torch.float32)
    intens = intens.to(torch.float32)
    n, s, _ = segs.shape
    px, py = _pixel_grid(h, w, segs.device)
    softness = segs.new_full((), 1.0 / h)
    fb = segs.new_zeros((n, h, w))
    for i in range(s):
        x0, y0, x1, y1, r = segs[:, i, :, None, None].unbind(1)
        inten = intens[:, i, None, None]
        dx, dy = x1 - x0, y1 - y0
        l2 = (dx * dx + dy * dy).clamp_min(_EPS)
        t = (((px - x0) * dx + (py - y0) * dy) / l2).clamp(0.0, 1.0)
        ex, ey = px - (x0 + t * dx), py - (y0 + t * dy)
        # The square root in float64, rounded to float32 once: the correctly
        # rounded float32 root, as the kernel's sqrtf gives it, on every
        # device. PyTorch's float32 sqrt on the CPU was seen to return roots
        # up to 3e-4 off (relative) in some calls.
        d = torch.sqrt((ex * ex + ey * ey).double()).float()
        cov = ((r - d) / softness + 0.5).clamp(0.0, 1.0) * inten
        fb = torch.maximum(fb, cov)
    return fb


__all__ = ["rasterize_ref"]
