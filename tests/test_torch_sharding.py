"""The port's sharding rules against the JAX package's.

`repro_torch.sharding.rules` returns, per leaf, the axis names a
`jax.sharding.PartitionSpec` holds. For every registry arch's reduced
params (JAX's from `jax.eval_shape`, the port's drawn under
FakeTensorMode: no memory either side), its Adam state and a decode cache,
the specs equal JAX's on the production meshes (16, 16) and (2, 16, 16),
built as `AbstractMesh`es so no device is needed. Batch specs and the
port's mesh, reshard and input stand-ins are checked beside them.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import input_specs as jax_input_specs
from repro.models import lm as jax_lm
from repro.sharding import rules as jax_rules
from repro.train.trainer import TrainConfig as JaxTrainConfig
from repro.train.trainer import make_optimizer as jax_make_optimizer
from repro_torch.configs.registry import ARCH_IDS, get_config, input_specs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.runtime.elastic import reshard_state
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


MESHES = {"pod16x16": (False, (16, 16), ("data", "model")),
          "pod2x16x16": (True, (2, 16, 16), ("pod", "data", "model"))}


def _jax_specs(tree):
    """{path: tuple(spec)} of a JAX spec tree."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {jax_rules._path_str(p): tuple(s) for p, s in leaves}


def _port_specs(tree):
    from torch.utils._pytree import tree_flatten_with_path

    leaves, _ = tree_flatten_with_path(tree, is_leaf=rules.is_spec)
    return {rules._path_str(p): s for p, s in leaves}


def _by_shape(jtree, jspecs, ttree, tspecs):
    """Sorted (shape, spec) pairs of both sides (the cache trees' node
    names differ between the packages; the specs depend on shapes only)."""
    jl = [tuple(x.shape) for x in jax.tree.leaves(jtree)]
    js = [tuple(s) for s in jax.tree.leaves(
        jspecs, is_leaf=lambda x: isinstance(x, P))]
    from torch.utils._pytree import tree_leaves

    tl = [tuple(x.shape) for x in tree_leaves(ttree)]
    ts = tree_leaves(tspecs, is_leaf=rules.is_spec)
    return sorted(zip(jl, js), key=repr), sorted(zip(tl, ts), key=repr)


@pytest.fixture(scope="module")
def trees():
    """Reduced params of every arch on both sides, no memory."""
    out = {}
    for arch in ARCH_IDS:
        jcfg = jax_get_config(arch, reduced=True)
        jp = jax.eval_shape(lambda k: jax_lm.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
        out[arch] = (jcfg, jp, get_config(arch, reduced=True),
                     dryrun.meta_params(get_config(arch, reduced=True)))
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_equal_jax(trees, arch, mesh_name):
    multi, sizes, names = MESHES[mesh_name]
    jmesh = AbstractMesh(sizes, names)
    mesh = make_production_mesh(multi_pod=multi)
    assert (tuple(mesh.shape.values()), mesh.axis_names) == (sizes, names)
    jcfg, jp, cfg, tp = trees[arch]
    want = _jax_specs(jax_rules.param_specs(jp, jmesh))
    got = _port_specs(rules.param_specs(tp, mesh))
    assert got == want
    assert any(any(a is not None for a in s) for s in got.values())

    jopt = jax.eval_shape(
        lambda p: jax_make_optimizer(JaxTrainConfig()).init(p), jp)
    jos = jax_rules.opt_specs(jopt, jp, jmesh)
    tos = rules.opt_specs(make_optimizer(TrainConfig()).init(tp), tp, mesh)
    assert tos.step == tuple(jos.step) == ()
    assert _port_specs(tos.mu) == _jax_specs(jos.mu) == want
    assert _port_specs(tos.nu) == _jax_specs(jos.nu)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_equal_jax(trees, arch, mesh_name):
    multi, sizes, names = MESHES[mesh_name]
    jmesh = AbstractMesh(sizes, names)
    mesh = make_production_mesh(multi_pod=multi)
    jcfg, _, cfg, _ = trees[arch]
    for b, seq_sharded in ((32, False), (1, True)):
        jc = jax.eval_shape(lambda: jax_lm.init_cache(jcfg, b, 64))
        tc = lm.init_cache(cfg, b, 64, "meta")
        want, got = _by_shape(jc, jax_rules.cache_specs(jmesh, jc, b,
                                                        seq_sharded),
                              tc, rules.cache_specs(mesh, tc, b, seq_sharded))
        assert got == want
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        jb = jax_input_specs(jcfg, shape)
        tb = input_specs(cfg, shape)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jb.items()} == {
            k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tb.items()}
        assert all(v.device.type == "meta" for v in tb.values())
        assert _port_specs(rules.batch_specs(mesh, tb)) == _jax_specs(
            jax_rules.batch_specs(jmesh, jb))


def test_host_mesh_and_reshard_on_one_device():
    mesh = make_host_mesh(device_type="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.devices == (torch.device("cpu"),)
    state = {"w": torch.ones(3), "opt": (torch.zeros(2), 5)}
    moved = reshard_state(state, mesh)
    assert torch.equal(moved["w"], state["w"]) and moved["opt"][1] == 5
    assert reshard_state(state, (torch.device("cpu"),))["w"].device.type == "cpu"
    with pytest.raises(NotImplementedError, match="2 devices"):
        reshard_state(state, (torch.device("cpu"), torch.device("cpu")))
    assert jnp is not None
