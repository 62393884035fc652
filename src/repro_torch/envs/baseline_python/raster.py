"""NumPy software rasteriser for the baseline ("AI Gym"-style) envs.

Single-frame, host-side. Mirrors the capsule semantics of
repro_torch.kernels.raster so rendered output is comparable; the point of the
baseline is the *execution model* (one interpreted step at a time, one frame
at a time), which is what the paper benchmarks against.
"""
from __future__ import annotations

import numpy as np

_EPS = 1e-8


def rasterize_np(segs, intens, h: int, w: int) -> np.ndarray:
    """segs: (S, 5) [x0,y0,x1,y1,r]; intens: (S,) -> (H, W) float32."""
    py = (np.arange(h, dtype=np.float32)[:, None] + 0.5) / h
    px = (np.arange(w, dtype=np.float32)[None, :] + 0.5) / w
    softness = 1.0 / h
    fb = np.zeros((h, w), np.float32)
    for (x0, y0, x1, y1, r), inten in zip(segs, intens):
        dx, dy = x1 - x0, y1 - y0
        l2 = max(dx * dx + dy * dy, _EPS)
        t = np.clip(((px - x0) * dx + (py - y0) * dy) / l2, 0.0, 1.0)
        cx, cy = x0 + t * dx, y0 + t * dy
        d = np.sqrt((px - cx) ** 2 + (py - cy) ** 2)
        cov = np.clip((r - d) / softness + 0.5, 0.0, 1.0) * inten
        np.maximum(fb, cov, out=fb)
    return fb
