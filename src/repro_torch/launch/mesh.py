"""Production meshes (port of `repro.launch.mesh`). Functions only:
importing this module touches no device and starts no process group.

A mesh here is its shape and axis names, with the devices it is laid over
where it has any, and the `torch.distributed` `DeviceMesh` that DTensors
live on once it is laid over a process group (`lay_over`):

  - on the card, `nccl` with one rank a card (`process_group`);
  - on CPU ranks, `gloo` (the tests' spawned ranks);
  - a described mesh such as `make_production_mesh()` (256 or 512 chips)
    over the fake process group at `Mesh.size` ranks (`described`): DTensor
    lays the step out and issues its collectives as on the real mesh, and
    nothing is sent; the tensors are fake (`FakeTensorMode`), so nothing is
    computed either. This is how the dry run and `launch/perf.py` see the
    production mesh with no devices, as JAX's
    `xla_force_host_platform_device_count=512` does.

Groups are made and destroyed by context managers, so a process is left
with no default group; each refuses to start where one exists already.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch


class Mesh(NamedTuple):
    """`shape` maps each axis name to its size, in order; `devices` are
    the devices the mesh is laid over, row-major (none for a described
    mesh); `device_mesh` the `DeviceMesh` over a process group, once laid
    over one (`lay_over`)."""

    shape: Dict[str, int]
    devices: Tuple[torch.device, ...] = ()
    device_mesh: Optional[Any] = None

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


def _no_default_group(what: str) -> None:
    import torch.distributed as dist

    if not dist.is_available():
        raise RuntimeError(f"{what}: this PyTorch has no torch.distributed")
    if dist.is_initialized():
        raise RuntimeError(f"{what}: a default process group exists already "
                           f"({dist.get_backend()}, world size "
                           f"{dist.get_world_size()}); it is not replaced")


@contextlib.contextmanager
def process_group(backend: str, world_size: int, rank: int,
                  init_method: str) -> Iterator[None]:
    """The default process group (`nccl` on cards, `gloo` on CPU ranks) for
    the block, destroyed after it. `init_method` is the rendezvous the
    ranks share (`tcp://localhost:<port>` or `file://<path>`)."""
    import torch.distributed as dist

    _no_default_group(f"process_group({backend!r})")
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_store():
    """The fake process group's store. It is private PyTorch API
    (`torch.testing._internal.distributed.fake_pg`, which registers the
    "fake" backend), kept to this one function."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "a described mesh needs PyTorch's fake process group "
            "(torch.testing._internal.distributed.fake_pg.FakeStore, private "
            "API), which this PyTorch lacks") from e
    return FakeStore()


@contextlib.contextmanager
def fake_group(world_size: int) -> Iterator[None]:
    """The fake process group as the default group for the block, this
    process its rank 0 of `world_size`: collectives are issued (and can be
    counted) but send nothing and return uninitialised tensors."""
    import torch.distributed as dist

    _no_default_group(f"fake_group({world_size})")
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=_fake_store())
    try:
        yield
    finally:
        dist.destroy_process_group()


def lay_over(mesh: Mesh, device_type: str) -> Mesh:
    """`mesh` with the `DeviceMesh` of its shape and axis names over the
    default process group's ranks (row-major) on `device_type`. The group
    must have `mesh.size` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if dist.get_world_size() != mesh.size:
        raise ValueError(f"a mesh of {mesh.size} ranks over a group of "
                         f"{dist.get_world_size()}")
    dm = init_device_mesh(device_type, tuple(mesh.shape.values()),
                          mesh_dim_names=mesh.axis_names)
    return mesh._replace(device_mesh=dm)


@contextlib.contextmanager
def described(mesh: Mesh) -> Iterator[Mesh]:
    """`mesh` laid over the fake group at `mesh.size` ranks, on "cpu"
    (the tensors laid out on it are meant to be fake: `FakeTensorMode`)."""
    with fake_group(mesh.size):
        yield lay_over(mesh, "cpu")


__all__ = ["Mesh", "described", "fake_group", "lay_over", "make_host_mesh",
           "make_production_mesh", "process_group"]
