"""The port stands alone: `repro_torch` imports neither JAX nor any module of
the JAX package `repro`, and runs on the CUDA card unless told otherwise."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import repro_torch

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
            "train.optim", "envs.baseline_python.classic"):
    assert "repro_torch." + mod in names, mod
"""


def test_importing_every_module_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, text=True,
                         capture_output=True, timeout=120, check=True).stdout
    count, _, bad = out.strip().partition(" ")
    assert int(count) >= 79, out
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


def test_dqn_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """The learner's entry points run on the card unless told otherwise,
    and there is no fused trainer yet."""
    from repro_torch import random as R
    from repro_torch.rl import dqn
    from repro_torch.rl.replay import replay_init

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env, cfg = repro_torch.make("CartPole-v1"), dqn.DQNConfig(memory_size=8)
    for entry in (lambda: dqn.train_compiled(env, cfg, 1, R.PRNGKey(0)),
                  lambda: dqn.dqn_init(env, cfg, R.PRNGKey(0)),
                  lambda: replay_init(8, (4,))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        dqn.train_compiled(env, cfg, 1, R.PRNGKey(0), fused=True,
                           device="cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        dqn.dqn_init(env, dqn.DQNConfig(memory_size=8, env_backend="cuda"),
                     R.PRNGKey(0), device="cpu")
