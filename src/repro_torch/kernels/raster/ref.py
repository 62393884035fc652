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
(chip_smoke.py). `tile_keep` is the plain twin of the kernel's per-tile
reach test, for the tests only.
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


def segment_coverage(segs: torch.Tensor, intens: torch.Tensor, h: int,
                     w: int):
    """Each segment's (N, H, W) coverage times its intensity, segment by
    segment in order: what `rasterize_ref` takes the running max of."""
    segs = segs.to(torch.float32)
    intens = intens.to(torch.float32)
    px, py = _pixel_grid(h, w, segs.device)
    softness = segs.new_full((), 1.0 / h)
    for i in range(segs.shape[1]):
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
        yield ((r - d) / softness + 0.5).clamp(0.0, 1.0) * inten


def rasterize_ref(segs: torch.Tensor, intens: torch.Tensor, h: int,
                  w: int) -> torch.Tensor:
    """segs (N, S, 5) `[x0, y0, x1, y1, radius]`, intens (N, S) -> (N, H, W)
    float32 framebuffers."""
    fb = segs.new_zeros((segs.shape[0], h, w), dtype=torch.float32)
    for cov in segment_coverage(segs, intens, h, w):
        fb = torch.maximum(fb, cov)
    return fb


def tile_keep(segs: torch.Tensor, intens: torch.Tensor, h: int, w: int,
              tile) -> torch.Tensor:
    """The reach test of csrc/raster.cu: (N, tiles, S) bool, True where a
    segment may cover a pixel of the tile. `tile` is (rows, cols) or one
    int for both; tiles run row-major over the frame, the ragged last ones
    cut at its edge. A segment is kept if its intensity is not 0 and its
    axis-aligned box, grown by r + softness, meets the box of the tile's
    pixel centres; the same float32 ops as the kernel's. Zeroing what it
    drops changes no bit of `rasterize_ref` within the tile (the kernel's
    header says why)."""
    th, tw = (tile, tile) if isinstance(tile, int) else tile
    segs = segs.to(torch.float32)
    intens = intens.to(torch.float32)
    px, py = _pixel_grid(h, w, segs.device)
    px, py = px[0], py[:, 0]
    first = lambda n, t: torch.arange(0, n, t, device=segs.device)
    last = lambda n, t: (first(n, t) + t).clamp_max(n) - 1
    x0, y0, x1, y1, r = segs.unbind(-1)                    # (N, S) each
    reach = r + segs.new_full((), 1.0 / h)

    def meets(a, b, centres, n, t):     # (N, tiles along the axis, S)
        lo = (torch.minimum(a, b) - reach)[:, None, :]
        hi = (torch.maximum(a, b) + reach)[:, None, :]
        return ((lo <= centres[last(n, t)][None, :, None])
                & (hi >= centres[first(n, t)][None, :, None]))

    keep = (meets(y0, y1, py, h, th)[:, :, None, :]
            & meets(x0, x1, px, w, tw)[:, None, :, :])
    keep = keep & (intens != 0)[:, None, None, :]
    return keep.reshape(segs.shape[0], -1, segs.shape[1])


__all__ = ["rasterize_ref", "segment_coverage", "tile_keep"]
