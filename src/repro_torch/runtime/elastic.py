"""Elastic scaling: re-mesh to whatever devices survive (port of
`repro.runtime.elastic`).

Checkpoints are gathered, whole-batch arrays (checkpoint/manager.py), and
a pool splits a snapshot over whatever devices it is built on (a
`ShardedEnvPool` over its tuple of devices), so scaling down after a loss
is: propose a mesh, rebuild the pool on it, restore. A mesh here is a
tuple of `torch.device`s. `reshard_state` places a restored state on a
mesh: on one device every leaf goes there; laying LM parameters over
several by the sharding rules (`sharding/rules.py`) is not ported, and it
raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def propose_mesh(n_devices: int, prefer_model: int = 16) -> Tuple[tuple, tuple]:
    """Largest (data, model) grid for n_devices; model axis capped/preferred.

    Keeps the model axis a power-of-two ≤ prefer_model that divides
    n_devices so TP sharding stays valid; leftover becomes data parallel.
    """
    if n_devices <= 0:
        raise ValueError("no devices")
    model = 1
    m = prefer_model
    while m > 1:
        if n_devices % m == 0:
            model = m
            break
        m //= 2
    data = n_devices // model
    return (data, model), ("data", "model")


def visible_devices(device_type: str = "cuda") -> int:
    """How many devices of `device_type` this process sees: the CUDA
    device count, or 1 for the CPU."""
    if device_type == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return 1


def build_mesh(n_devices: Optional[int] = None,
               device_type: str = "cuda") -> Tuple[torch.device, ...]:
    """The first `n_devices` visible devices of `device_type` (all by
    default): the CUDA devices in index order, or the one CPU. Raises if
    more are asked for than exist."""
    have = visible_devices(device_type)
    n = have if n_devices is None else int(n_devices)
    if not 1 <= n <= have:
        raise ValueError(f"a mesh of {n} {device_type} devices; {have} "
                         "visible")
    if device_type == "cuda":
        return tuple(torch.device("cuda", i) for i in range(n))
    return (torch.device(device_type),)


def reshard_state(state, mesh):
    """Re-place a (restored) state tree onto `mesh`: a tuple of devices, or
    a `launch/mesh.py::Mesh` laid over devices. On a one-device mesh every
    tensor leaf moves to that device. On more devices the JAX package lays
    each leaf out by `sharding.rules.param_specs`; the port has no
    sharded tensors to lay them into, so that raises NotImplementedError
    (ROADMAP: LM parameter sharding across cards)."""
    from torch.utils._pytree import tree_map

    devices = tuple(getattr(mesh, "devices", mesh))
    if len(devices) != 1:
        raise NotImplementedError(
            f"reshard_state over {len(devices)} devices: laying LM "
            "parameters over several cards by the sharding rules is not "
            "ported; one device takes the whole state")
    dev = torch.device(devices[0])
    return tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor)
                    else x, state)


__all__ = ["build_mesh", "propose_mesh", "reshard_state", "visible_devices"]
