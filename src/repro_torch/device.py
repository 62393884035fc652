"""Where the port runs: the CUDA card unless the caller names a device."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when None; raises if CUDA is absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the CUDA card by default and no CUDA "
                "device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


__all__ = ["resolve_device"]
