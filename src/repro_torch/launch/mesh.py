"""Production meshes (port of `repro.launch.mesh`). Functions only:
importing this module touches no device.

A mesh here is its shape and axis names, with the devices it is laid over
where it has any: `make_production_mesh` describes the JAX package's
production meshes, which the dry run lays the sharding rules over with no
device at all; `make_host_mesh` is this host's devices
(`runtime.elastic.build_mesh`).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch


class Mesh(NamedTuple):
    """`shape` maps each axis name to its size, in order; `devices` are
    the devices the mesh is laid over, row-major (none for a described
    mesh)."""

    shape: Dict[str, int]
    devices: Tuple[torch.device, ...] = ()

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) single pod = 256 chips; (2, 16, 16) = 2 pods, 512 chips."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def make_host_mesh(model: int = 1, device_type: str = "cuda") -> Mesh:
    """What this host has: its devices of `device_type` (the CUDA cards, or
    the one CPU) as a (data, model) mesh, `model` capped at the count."""
    from repro_torch.runtime.elastic import build_mesh

    devices = build_mesh(device_type=device_type)
    n = len(devices)
    model = max(1, min(model, n))
    return Mesh({"data": n // model, "model": model}, devices)


__all__ = ["Mesh", "make_host_mesh", "make_production_mesh"]
