"""The port's sharded LM train step on 4 CPU ranks, against the port's
one-device step and the JAX package's single-device step.

One spawn of 4 `gloo` ranks (a `file://` rendezvous under the test's
tmp dir, one intra-op thread a rank) runs every sharded check and writes
its results; the ranks start while the parent runs the JAX steps, whose
state they then read, and the parent holds their results against the
references it computes itself:

- on a (2, 2) ("data", "model") mesh, the reduced yi-6b (dense GQA: 4
  query heads, 2 KV heads) and the reduced olmoe-1b-7b (MoE: 8 experts,
  top 2) take 2 steps from the same numpy state and batches, laid out by
  `reshard_state` (params, Adam's mu and nu as DTensors by the sharding
  rules; every leaf's local shape is `rules.local_shape` of its spec).
  The state is the JAX package's after one step of its jitted
  `make_train_step`, carried across as tests/test_torch_trainer.py
  carries it. Their losses, grad norms and whole params after the 2
  steps are held against the port's one-device step at 1e-5 (rtol and
  atol: f32 sums split over ranks round otherwise), and against the JAX
  package's next 2 steps at 1e-5 for the losses and 1e-4 for the params
  (rtol, and atol times the leaf's largest entry);
- the elastic case of tests/test_sharding.py (a save on a (2, 4) mesh
  restored onto (4, 1)) on 4 ranks: params laid out on (2, 2), saved by
  `CheckpointManager` (every rank gathers, rank 0 writes), restored with
  `shardings=` onto (4, 1) and onto (2, 1) over ranks 0 and 1: every
  value exact, every placement the target's.
"""
import json
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCHS = ("yi-6b", "olmoe-1b-7b")
STEPS = 2
RANKS = 4
#: the port's sharded step against its one-device step
TOL_PORT = dict(rtol=1e-5, atol=1e-5)
#: against the JAX package's step: losses, then params (leaf-scaled atol)
TOL_JAX_LOSS = dict(rtol=1e-5, atol=1e-5)
TOL_JAX_PARAMS = dict(rtol=1e-4, atol=1e-4)


def _train_config():
    from repro_torch.train.trainer import TrainConfig

    return TrainConfig(lr=1e-3, warmup=1, total_steps=10, remat="none")


def _flat(tree):
    from repro_torch.checkpoint.manager import flatten_with_path

    return dict(flatten_with_path(tree))


def _inputs(out_dir, timeout=600.0):
    """The parent's inputs, once its JAX steps have written them (the ranks
    start up and meet meanwhile). They come in a file: spawn arguments
    larger than a pipe's buffer would hold each spawn until its child had
    imported torch."""
    path = os.path.join(out_dir, "inputs.pkl")
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def _rank(rank, store, out_dir):
    """One rank: the sharded steps, then the elastic restores."""
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.utils._pytree import tree_leaves

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import Mesh, lay_over, process_group
    from repro_torch.models import lm
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.sharding import rules
    from repro_torch.train.trainer import make_train_step, state_from_numpy

    tc = _train_config()
    res = {}
    with process_group("gloo", RANKS, rank, f"file://{store}"):
        mesh = lay_over(Mesh({"data": 2, "model": 2}), "cpu")
        inputs = _inputs(out_dir)
        for arch, (params_np, opt_np, batches) in inputs.items():
            cfg = get_config(arch, reduced=True)
            p, opt = reshard_state(state_from_numpy(params_np, opt_np, "cpu"),
                                   mesh)
            specs = tree_leaves(rules.param_specs(p, mesh),
                                is_leaf=rules.is_spec)
            shapes = [(tuple(x.to_local().shape),
                       rules.local_shape(x.shape, s, mesh))
                      for tree in (p, opt.mu, opt.nu)
                      for x, s in zip(lm.tree_leaves(tree), specs)]
            step = make_train_step(cfg, tc)
            metrics = []
            for batch in batches:
                p, opt, m = step(p, opt, batch)
                metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
            whole = {k: v.full_tensor().numpy() for k, v in _flat(p).items()}
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{arch}.npz"), **whole)
            res[arch] = {"metrics": metrics,
                         "local_shapes_ok": all(a == b for a, b in shapes),
                         "sharded_leaves": sum(
                             any(not pl.is_replicate() for pl in x.placements)
                             for x in lm.tree_leaves(p))}

        # elastic: (2, 2) -> checkpoint -> (4, 1), and (2, 1) on ranks 0-1
        params_np = inputs["yi-6b"][0]
        template = lm.params_from_numpy(params_np, "cpu")
        mgr = CheckpointManager(os.path.join(out_dir, "ckpt"))
        mgr.save(1, reshard_state(template, mesh))
        want = _flat(template)
        targets = {"4x1": lay_over(Mesh({"data": 4, "model": 1}), "cpu")}
        pair = DeviceMesh("cpu", [[0], [1]], mesh_dim_names=("data", "model"))
        if rank < 2:
            targets["2x1"] = pair
        for name, target in targets.items():
            sh = rules.to_shardings(rules.param_specs(template, target), target)
            got = mgr.restore(template, shardings=sh)
            exact = placed = True
            sh_flat = _flat(sh)
            for key, x in _flat(got).items():
                placed &= tuple(x.placements) == sh_flat[key].placements
                exact &= torch.equal(x.full_tensor(), want[key])
            res[f"restore_{name}"] = {"exact": bool(exact),
                                      "placed": bool(placed)}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The JAX package's steps and the 4 ranks' results: {arch: (carried
    numpy params and AdamState, batches, JAX losses, JAX params)}, [rank
    results], out dir."""
    out = tmp_path_factory.mktemp("sharded")
    ranks = mp.spawn(_rank, args=(str(out / "store"), str(out)),
                     nprocs=RANKS, join=False)
    try:
        setups = {arch: _jax(arch) for arch in ARCHS}
        with open(out / "inputs.tmp", "wb") as f:
            pickle.dump({arch: v[:3] for arch, v in setups.items()}, f)
        os.replace(out / "inputs.tmp", out / "inputs.pkl")
    except BaseException:
        for proc in ranks.processes:     # they would wait for the inputs
            proc.terminate()
        raise
    while not ranks.join():
        pass
    results = [json.loads((out / f"rank{r}.json").read_text())
               for r in range(RANKS)]
    return setups, results, out


def _jax(arch):
    """The JAX package's jitted step from numpy draws: one step on its own
    batch (so Adam's mu and nu are not 0, as tests/test_torch_trainer.py
    carries them; a first Adam step turns f32's rounding of a near-zero
    gradient into a whole step of lr), that state carried as numpy, then
    `STEPS` steps: (params, opt state, batches, losses, {path: params})."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.train import trainer as jax_trainer
    from test_torch_lm_train import jax_setup, make_batch

    jcfg, params = jax_setup(arch)
    tc = jax_trainer.TrainConfig(**dataclasses.asdict(_train_config()))
    step = jax.jit(jax_trainer.make_train_step(jcfg, tc))
    p = jax.tree.map(jnp.asarray, params)
    opt = jax_trainer.make_optimizer(tc).init(p)
    p, opt, _ = step(p, opt, make_batch(jcfg, 100, b=4))
    carried = jax.tree.map(np.asarray, (p, opt))
    batches = [make_batch(jcfg, 50 + s, b=4) for s in range(STEPS)]
    losses = []
    for batch in batches:
        p, opt, m = step(p, opt, batch)
        losses.append(float(m["loss"]))
    flat = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(p)[0]}
    return carried[0], carried[1], batches, losses, flat


def _one_device(arch, params, opt, batches):
    from repro_torch.configs.registry import get_config
    from repro_torch.train.trainer import make_train_step, state_from_numpy

    p, opt = state_from_numpy(params, opt, "cpu")
    step = make_train_step(get_config(arch, reduced=True), _train_config())
    metrics = []
    for batch in batches:
        p, opt, m = step(p, opt, batch)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return metrics, {k: v.numpy() for k, v in _flat(p).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_steps_match_one_device_and_jax(sharded, arch):
    setups, results, out = sharded
    params, opt, batches, jax_losses, jax_params = setups[arch]
    got = results[0][arch]
    assert got["local_shapes_ok"] and got["sharded_leaves"] > 4
    assert all(r[arch]["metrics"] == got["metrics"] for r in results)
    metrics, want = _one_device(arch, params, opt, batches)
    whole = dict(np.load(out / f"{arch}.npz"))
    assert sorted(whole) == sorted(want)
    for s, (a, b) in enumerate(zip(got["metrics"], metrics)):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], err_msg=f"step {s} {k}",
                                       **TOL_PORT)
    for key, x in want.items():
        np.testing.assert_allclose(whole[key], x, err_msg=key, **TOL_PORT)
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                               jax_losses, **TOL_JAX_LOSS)
    assert sorted(jax_params) == sorted(whole)
    for key, x in jax_params.items():
        atol = TOL_JAX_PARAMS["atol"] * float(np.abs(x).max())
        np.testing.assert_allclose(whole[key], x, rtol=TOL_JAX_PARAMS["rtol"],
                                   atol=atol, err_msg=key)


@pytest.mark.parametrize("target", ["4x1", "2x1"])
def test_elastic_restore_onto_other_meshes_is_exact(sharded, target):
    _, results, _ = sharded
    ranks = range(RANKS) if target == "4x1" else range(2)
    for r in ranks:
        assert results[r][f"restore_{target}"] == {"exact": True,
                                                    "placed": True}, r
    assert all(f"restore_{target}" not in results[r]
               for r in set(range(RANKS)) - set(ranks))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_sharded_step_is_the_plain_step_bit_for_bit(arch, tmp_path):
    """On a (1, 1) mesh over one gloo rank the DTensor step runs the plain
    step's aten calls on whole tensors: 2 steps (remat "dots"), losses,
    grad norms and params equal bit for bit (chip_smoke.py's phase
    sharded holds the same on the card, through the kernel)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import Mesh, lay_over, process_group
    from repro_torch.models import lm
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.train.trainer import make_optimizer, make_train_step

    cfg = get_config(arch, reduced=True)
    tc = dataclasses.replace(_train_config(), remat="dots")
    tokens = torch.randint(0, cfg.vocab_size, (4, 32),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens, "labels": tokens.roll(1, 1)}
    runs = {}
    with process_group("gloo", 1, 0, f"file://{tmp_path / 'store'}"):
        mesh = lay_over(Mesh({"data": 1, "model": 1}), "cpu")
        for sharded in (False, True):
            p = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
            opt = make_optimizer(tc).init(p)
            if sharded:
                p, opt = reshard_state((p, opt), mesh)
            step = make_train_step(cfg, tc)
            metrics = []
            for _ in range(STEPS):
                p, opt, m = step(p, opt, batch)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            runs[sharded] = metrics, [x.full_tensor() if sharded else x
                                      for x in lm.tree_leaves(p)]
    assert runs[True][0] == runs[False][0]
    for a, b in zip(runs[True][1], runs[False][1]):
        assert torch.equal(a, b)
