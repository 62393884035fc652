"""The port's public surface against the JAX package's snapshot.

`tests/test_api_surface.py::API_SURFACE` pins the drop-in surface of the
JAX package (paper Listing 2). The port's modules of the same names
(`repro_torch`, `.core`, `.pool`, `.cairl`, `.train`) export that surface
less the names still to port, each of which names its ROADMAP item below;
and every exported name resolves.
"""
import importlib

import pytest
import torch

from test_api_surface import API_SURFACE, _surface


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: JAX-package names the port does not export yet, by module, with the
#: ROADMAP item each comes with (none: the whole surface is ported)
PENDING = {}
PORTED = ("repro", "repro.core", "repro.pool", "repro.cairl", "repro.train")


def _port_name(modname: str) -> str:
    return "repro_torch" + modname[len("repro"):]


@pytest.mark.parametrize("modname", PORTED)
def test_port_surface_is_the_snapshot_less_pending(modname):
    module = importlib.import_module(_port_name(modname))
    want = sorted(set(API_SURFACE[modname]) - set(PENDING.get(modname, {})))
    got = _surface(module)
    assert got == want, (f"{_port_name(modname)}: missing "
                         f"{sorted(set(want) - set(got))}, added "
                         f"{sorted(set(got) - set(want))}")
    for name in got:
        assert getattr(module, name, None) is not None, f"{modname}.{name}"


def test_pending_names_are_in_the_snapshot_and_absent():
    """Each pending name is one the JAX package exports and the port does
    not, and its ROADMAP item is one of the items still open."""
    for modname, names in PENDING.items():
        module = importlib.import_module(_port_name(modname))
        for name, item in names.items():
            assert name in API_SURFACE[modname], (modname, name)
            assert name not in _surface(module), (modname, name)
            assert item in ("A11", "A12", "A13", "A14"), (name, item)
