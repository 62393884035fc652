"""Where the port runs: the CUDA card unless the caller names a device."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when None. Raises if the result is a CUDA
    device and CUDA is absent, so a request for the card never runs
    anywhere else."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the CUDA card by default and no CUDA "
                "device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device} was asked for and no CUDA device is "
                           "available")
    return device


__all__ = ["resolve_device"]
