"""The port's dry run against the JAX package's shapes.

For every full config (published widths and depths: no memory on either
side), the dry run's meta-device params and Adam state hold exactly the
bytes of the JAX package's `jax.eval_shape` trees, and its per-device
bytes under the production mesh's specs are those leaves divided as the
specs say. One cell's FLOPs run on meta tensors.
"""
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs.registry import get_config as jax_get_config
from repro.models import lm as jax_lm
from repro.sharding import rules as jax_rules
from repro.train.trainer import TrainConfig as JaxTrainConfig
from repro.train.trainer import make_optimizer as jax_make_optimizer
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import rules
from repro_torch.train.trainer import TrainConfig, make_optimizer


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_bytes(tree):
    return sum(math.prod(x.shape) * x.dtype.itemsize
               for x in jax.tree.leaves(tree))


def _jax_sharded_bytes(tree, specs, mesh):
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    total = 0
    for x, s in zip(leaves, spec_leaves, strict=True):
        n = 1
        for d, axes in zip(x.shape, tuple(s) + (None,) * (len(x.shape) - len(s))):
            names = () if axes is None else (axes,) if isinstance(axes, str) else axes
            n *= d // math.prod(mesh.shape[a] for a in names)
        total += n * x.dtype.itemsize
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_optimizer_bytes_equal_jax_eval_shape(arch):
    jcfg = jax_get_config(arch)
    jp = jax.eval_shape(lambda k: jax_lm.init_params(jcfg, k),
                        jax.random.PRNGKey(0))
    jopt = jax.eval_shape(
        lambda p: jax_make_optimizer(JaxTrainConfig()).init(p), jp)
    tp = dryrun.meta_params(get_config(arch))
    topt = make_optimizer(TrainConfig()).init(tp)
    assert all(x.device.type == "meta" for x in jax.tree.leaves(
        [topt.mu, topt.nu]) if isinstance(x, torch.Tensor))
    assert dryrun.tree_bytes(tp) == _jax_bytes(jp)
    assert dryrun.tree_bytes(topt) == _jax_bytes(jopt)
    mesh = make_production_mesh()
    jmesh = AbstractMesh((16, 16), ("data", "model"))
    assert dryrun.sharded_bytes(tp, rules.param_specs(tp, mesh), mesh) == (
        _jax_sharded_bytes(jp, jax_rules.param_specs(jp, jmesh), jmesh))


def test_cells_report_bytes_fit_and_flops():
    cell = dryrun.run_cell("h2o-danube-1.8b", "prefill_32k", multi_pod=False)
    assert cell["status"] == "ok" and cell["chips"] == 256
    assert set(cell["bytes_per_device"]) == {"params", "batch"}
    assert cell["fits_h100_80gb"] and cell["collective_bytes_per_device"] is None
    assert cell["flash_launches"] == get_config("h2o-danube-1.8b").num_layers
    assert cell["flops"] > cell["flash_flops"] > 0
    skipped = dryrun.run_cell("yi-6b", "long_500k", multi_pod=True, flops=False)
    assert skipped["status"] == "skipped"
    train = dryrun.run_cell("yi-6b", "train_4k", multi_pod=True, flops=False)
    assert train["bytes_whole"]["opt"] == 2 * train["bytes_whole"]["params"] + 4
    assert train["bytes_per_device"]["params"] < train["bytes_whole"]["params"]
    assert "flops" not in train
    decode = dryrun.run_cell("minicpm3-4b", "decode_32k", multi_pod=True,
                             flops=False)
    assert set(decode["bytes_per_device"]) == {"params", "caches", "batch"}
    assert not decode["whole_fits_one_h100_80gb"] and decode["fits_h100_80gb"]
