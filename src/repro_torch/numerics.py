"""Float32 arithmetic that rounds alike on the CPU and on the card.

The CUDA kernels are held bit for bit against the plain PyTorch versions,
and the plain versions against the JAX package, so an op whose rounding
depends on the device is written here once.
"""
from __future__ import annotations

import numpy as np
import torch


def f32(x: float) -> float:
    """`x` rounded to float32, held as a Python float: a constant that
    compares or combines with a float32 tensor as JAX's weakly typed Python
    scalar does, on every device."""
    return float(np.float32(x))


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as one IEEE float32 division on every device, c rounded to
    float32 first. PyTorch's CUDA kernel for `tensor / python_float` rounds
    otherwise, so the divisor goes in as a 0-dim tensor on x's device."""
    return x / x.new_full((), c)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on every device.

    PyTorch's float32 `sqrt` on the CPU is off by an ulp or more in some
    lanes (in some processes by far more), so there the root is taken in
    float64 and rounded once, which is exact for a square root. The CUDA
    `sqrtf` is IEEE already."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


__all__ = ["div", "f32", "sqrt"]
