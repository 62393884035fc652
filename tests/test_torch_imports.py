"""The port stands alone: `repro_torch` imports neither JAX nor any module of
the JAX package `repro`, and runs on the CUDA card unless told otherwise:
its entry points (`make_vec`, `cairl.make`, the DQN and PPO trainers, the
fused trainer and fleets, the async, sharded and supervised pools, the env
service and the LM training launcher) raise without a card when no device
is named; the checkpoint manager, the failure harness and `propose_mesh`
are host-only."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import repro_torch


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
PKG = SRC / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(("jax.", "repro.")))
print(len(names), ",".join(bad))
for mod in ("envs.grid.snake", "envs.puzzle", "envs.multitask", "models.lm",
            "kernels.attention.ops", "serving.engine", "rl.dqn",
            "train.optim", "envs.baseline_python.classic", "cairl",
            "core.gym_compat", "core.runner", "pool.host", "runtime.straggler",
            "rl.ppo", "train.fused", "sustainability.impact",
            "pool.async_pool", "pool.sharded", "runtime.failures",
            "runtime.elastic", "runtime.supervisor", "checkpoint.manager",
            "serving.env_service", "models.moe", "models.gla", "models.ssm",
            "data.synthetic", "train.trainer", "train.compression",
            "launch.train"):
    assert "repro_torch." + mod in names, mod
"""


def test_importing_every_module_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, text=True,
                         capture_output=True, timeout=120, check=True).stdout
    count, _, bad = out.strip().partition(" ")
    assert int(count) >= 99, out
    assert bad == "", f"repro_torch pulled in {bad}"


def test_no_source_names_jax_or_repro():
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_make_vec_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.make_vec("CartPole-v1", 4)
    pool = repro_torch.make_vec("CartPole-v1", 4, device="cpu")
    assert pool.device == torch.device("cpu") and pool.backend == "torch"


def test_lm_training_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """The training launcher and `init_train_state` run on the card unless
    told otherwise; told the CPU, the launcher trains there."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import lm
    from repro_torch.train.trainer import TrainConfig, init_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "yi-6b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(get_config("yi-6b", reduced=True), TrainConfig(),
                         torch.Generator())
    out = launch_train.main(["--arch", "yi-6b", "--steps", "1", "--batch", "2",
                             "--seq", "8", "--device", "cpu"])
    assert out["device"] == torch.device("cpu")
    assert all(x.device.type == "cpu" for x in
               lm.tree_leaves(out["params"]))


def test_dqn_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """The learners' entry points run on the card unless told otherwise:
    DQN (host-alternating and fused), PPO, fleets, the Gym shim and the
    runners (a key made on the CPU included). Told the CPU, the fused DQN
    trainer gives the host-alternating state."""
    from torch.utils._pytree import tree_leaves

    from repro_torch import cairl
    from repro_torch import random as R
    from repro_torch.core import runner
    from repro_torch.rl import dqn, ppo
    from repro_torch.rl.replay import replay_init
    from repro_torch.train import fleet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env, cfg = repro_torch.make("CartPole-v1"), dqn.DQNConfig(memory_size=8)
    pcfg = ppo.PPOConfig(num_envs=2, rollout_len=2)

    def policy(params, obs, keys):
        return torch.zeros(obs.shape[:-1], dtype=torch.int32,
                           device=obs.device)

    for entry in (lambda: dqn.train_compiled(env, cfg, 1, R.PRNGKey(0)),
                  lambda: dqn.train_compiled(env, cfg, 1, R.PRNGKey(0),
                                             fused=True),
                  lambda: dqn.dqn_init(env, cfg, R.PRNGKey(0)),
                  lambda: replay_init(8, (4,)),
                  lambda: cairl.make("CartPole-v1"),
                  lambda: ppo.train(env, pcfg, 1, R.PRNGKey(0)),
                  lambda: fleet(env, [0], 1, cfg=cfg),
                  lambda: runner.rollout(env, policy, None, 1, 2,
                                         R.PRNGKey(0)),
                  lambda: runner.rollout_random(env, R.PRNGKey(0), 1, 2),
                  lambda: runner.rollout_random_fast(env, R.PRNGKey(0), 1, 2),
                  lambda: runner.episode_return(env, policy, None,
                                                R.PRNGKey(0), 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    cfg = dqn.DQNConfig(memory_size=8, learn_start=2, batch_size=2)
    fused, _, fm = dqn.train_compiled(env, cfg, 5, R.PRNGKey(0), fused=True,
                                      device="cpu")
    host, _, hm = dqn.train_compiled(env, cfg, 5, R.PRNGKey(0), device="cpu")
    for a, b in zip(tree_leaves((fused, fm)), tree_leaves((host, hm))):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        dqn.dqn_init(env, dqn.DQNConfig(memory_size=8, env_backend="cuda"),
                     R.PRNGKey(0), device="cpu")


def test_async_runtime_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path):
    """The async pool, the env service and the sharded pool (and its
    default mesh) run on the card unless told otherwise, and raise without
    one; so do the pools `RolloutSupervisor.recover()` rebuilds for a pool
    on the card. The checkpoint manager, the failure harness and
    `propose_mesh` are host-only and run without a card."""
    import numpy as np

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.pool import (AsyncEnvPool, ShardedEnvPool,
                                  default_pool_mesh, make_pool)
    from repro_torch.runtime import (FaultInjector, HeartbeatMonitor,
                                     RolloutSupervisor, build_mesh,
                                     plan_recovery, propose_mesh)
    from repro_torch.serving import EnvService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (lambda: AsyncEnvPool("CartPole-v1", 2),
                  lambda: repro_torch.make_vec("CartPole-v1", 2,
                                               backend="async"),
                  lambda: EnvService("CartPole-v1", 2),
                  lambda: ShardedEnvPool("CartPole-v1", 2),
                  lambda: default_pool_mesh(),
                  lambda: repro_torch.make_vec("CartPole-v1", 2,
                                               mesh=("cuda:0",)),
                  lambda: make_pool("CartPole-v1", 2, backend="sharded")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    with pytest.raises(ValueError, match="0 visible"):
        build_mesh(1)
    assert propose_mesh(8, prefer_model=1) == ((8, 1), ("data", "model"))
    clk = [0.0]
    mon = HeartbeatMonitor(2, timeout_s=1.0, clock=lambda: clk[0])
    inj = FaultInjector(clock=lambda: clk[0])
    inj.schedule(0.0, "device_loss")
    assert [f.kind for f in inj.due()] == ["device_loss"]
    assert plan_recovery(mon, 1, None).new_device_count == 2
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(1, {"x": np.arange(3)})
        assert mgr.restore({"x": np.zeros(3, np.int64)})["x"].tolist() == [
            0, 1, 2]
    sup = RolloutSupervisor(AsyncEnvPool("CartPole-v1", 2, device="cpu"),
                            str(tmp_path / "sup"), snapshot_every=1,
                            blocking_snapshots=True)
    sup.reset(seed=0)
    sup.step(np.zeros(2, np.int32))
    assert sup.recover()["mesh"] == ["cpu"]
    assert sup.pool.device == torch.device("cpu")
