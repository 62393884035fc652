"""The port's PPO (`repro_torch.rl.ppo`) against the JAX package, on the CPU.

  - `ac_init` and `ac_apply` with JAX's params carried across;
  - `_gae` on the same rewards, values and dones;
  - the clipped-surrogate loss and its gradients from carried params,
    against the JAX package's loss (the body of its `make_update_body`'s
    `loss_fn`, restated below);
  - one `update_body` from a carried JAX `PPOState` on "torch", under a
    TimeLimit of 10, so truncated steps bootstrap through `terminal_obs`;
  - the committed golden `tests/golden/train_ppo_CartPole-v1.json` through
    `train` on "torch" (tests/test_torch_fused.py answers it on "vmap"):
    floats within 1e-4, the key exactly.

Floats are held to 1e-5/1e-6 (`conftest.assert_leaves_match`), ints and
keys exactly. JAX runs in the legacy threefry layout of the goldens.
"""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.pipeline as JP
import repro.envs.classic as JC
import repro_torch
import repro_torch.core.pipeline as TP
import repro_torch.envs.classic as TC
from conftest import assert_leaves_match
from repro.rl import ppo as JPPO
from repro_torch import random as R
from repro_torch.rl import dqn as TD
from repro_torch.rl import ppo as TPPO
from repro_torch.train import fused as TF

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
CPU = "cpu"
legacy = lambda: jax.threefry_partitionable(False)
CFG = dict(num_envs=4, rollout_len=16, epochs=2, minibatches=2)
LIMIT = 10


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are tiny: PyTorch's intra-op threads only add
    overhead to them, so each test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy(x: torch.Tensor) -> np.ndarray:
    a = x.detach().numpy()
    return a.astype(np.uint32) if x.dtype == R.KEY_DTYPE else a


def _match(want, got, what):
    """`got` (the port's tree) against `want` (JAX's), NamedTuples by field
    name, dicts by key, lists and tuples by position, leaves by the parity
    contract."""
    if isinstance(got, tuple) and hasattr(got, "_fields"):
        assert got._fields == want._fields, what
        for f in got._fields:
            _match(getattr(want, f), getattr(got, f), f"{what}.{f}")
    elif isinstance(got, dict):
        assert sorted(got) == sorted(want), what
        for k in got:
            _match(want[k], got[k], f"{what}[{k}]")
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want), what
        for i, (w, g) in enumerate(zip(want, got)):
            _match(w, g, f"{what}[{i}]")
    else:
        assert_leaves_match(np.asarray(want), _numpy(got), what)


def _carry(tree):
    return TD.params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


def _jax_loss(params, batch, cfg):
    """The JAX package's PPO loss, restated from the `loss_fn` closure of
    `repro.rl.ppo.make_update_body` (not importable on its own)."""
    obs, action, logp_old, adv, ret = batch
    logits, value = JPPO.ac_apply(params, obs, cfg.activation)
    logp = jax.nn.log_softmax(logits)[jnp.arange(obs.shape[0]), action]
    ratio = jnp.exp(logp - logp_old)
    pg = -jnp.mean(jnp.minimum(
        ratio * adv, jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv))
    vf = jnp.mean((value - ret) ** 2)
    probs = jax.nn.softmax(logits)
    ent = -jnp.mean(jnp.sum(probs * jnp.log(probs + 1e-10), axis=-1))
    return pg + cfg.vf_coef * vf - cfg.ent_coef * ent


@pytest.fixture(scope="module")
def jax_params():
    with legacy():
        return jax.jit(lambda k: JPPO.ac_init(k, 4, 2, JPPO.PPOConfig()))(
            jax.random.PRNGKey(3))


def test_ac_init_apply_and_loss_gradients(jax_params):
    """Init from the same key, `ac_apply`, and the loss and its gradients
    over a 64-row minibatch, from params carried across."""
    cfg_j, cfg_t = JPPO.PPOConfig(), TPPO.PPOConfig()
    _match(jax_params, TPPO.ac_init(R.PRNGKey(3), 4, 2, cfg_t), "ac_init")
    params = TPPO.ACParams(*(_carry(p) for p in jax_params))
    rng = np.random.default_rng(0)
    obs = rng.normal(0, 1, (64, 4)).astype(np.float32)
    want = jax.jit(JPPO.ac_apply)(jax_params, obs)
    _match(want, TPPO.ac_apply(params, torch.from_numpy(obs)), "ac_apply")
    action = rng.integers(0, 2, 64).astype(np.int32)
    logp_old = rng.normal(-0.7, 0.1, 64).astype(np.float32)
    adv = rng.normal(0, 1, 64).astype(np.float32)
    ret = rng.normal(1, 2, 64).astype(np.float32)
    batch = (obs, action, logp_old, adv, ret)
    w_loss, w_grads = jax.jit(jax.value_and_grad(
        lambda p, b: _jax_loss(p, b, cfg_j)))(jax_params, batch)
    loss, grads = TD.value_and_grad(
        lambda p: TPPO.ppo_loss(p, tuple(map(torch.from_numpy, batch)),
                                cfg_t), params)
    _match(w_loss, loss, "loss")
    _match(w_grads, grads, "gradients")


def test_gae_matches_jax():
    rng = np.random.default_rng(1)
    t, b = 16, 4
    r, v = (rng.normal(0, 1, (t, b)).astype(np.float32) for _ in range(2))
    d = (rng.uniform(0, 1, (t, b)) < 0.2).astype(np.float32)
    last = rng.normal(0, 1, b).astype(np.float32)
    want = jax.jit(JPPO._gae, static_argnums=(4, 5))(r, v, d, last, 0.99, 0.95)
    got = TPPO._gae(*map(torch.from_numpy, (r, v, d, last)), 0.99, 0.95)
    _match(want, got, "gae")


@pytest.fixture(scope="module")
def jax_update():
    """JAX's initial `PPOState` and the state and metrics after one update,
    on CartPole under a TimeLimit of 10."""
    env = JP.build_pipeline(JC.CartPole(), (JP.TimeLimit(LIMIT),))
    cfg = JPPO.PPOConfig(**CFG)
    with legacy():
        state0 = jax.jit(lambda k: JPPO.ppo_init(env, cfg, k))(
            jax.random.PRNGKey(9))
        state1, metrics = JPPO.make_update(env, cfg)(state0)
    return (jax.tree.map(np.asarray, state0), jax.tree.map(np.asarray, state1),
            jax.tree.map(np.asarray, metrics))


def test_update_body_from_a_carried_state(jax_update):
    """One port update from JAX's initial state gives JAX's state after one:
    params, Adam, the pool carry, the key chain and the returns, on the
    plain megastep ("torch", the CUDA kernel's twin)."""
    backend = "torch"
    state0, want, want_metrics = jax_update
    env = TP.build_pipeline(TC.CartPole(), (TP.TimeLimit(LIMIT),))
    cfg = TPPO.PPOConfig(**CFG, env_backend=backend)
    state = TPPO.state_from_numpy(state0, env, cfg, CPU)
    _match(state0, state, "carried initial state")
    got, metrics = TPPO.make_update_body(env, cfg, CPU)(state)
    _match(want, got, f"state after one update ({backend})")
    _match(want_metrics, metrics, "metrics")
    assert float(got.last_return.sum()) > 0


def test_golden_ppo_trace():
    """The golden on the plain megastep ("torch"); tests/test_torch_fused.py
    answers it on "vmap", fused."""
    backend = "torch"
    want = json.loads((GOLDEN_DIR / "train_ppo_CartPole-v1.json").read_text())
    _, env_id, cfg, steps = TF.golden_train_setup("ppo/CartPole-v1")
    assert cfg == TPPO.PPOConfig(**CFG)
    cfg = dataclasses.replace(cfg, env_backend=backend)
    env = repro_torch.make(env_id)
    state, metrics = TPPO.train(env, cfg, steps,
                                R.PRNGKey(sum(map(ord, "ppo/CartPole-v1"))),
                                device=CPU)
    assert tuple(metrics["loss"].shape) == (steps,)
    got = TD.golden_checksums(
        env, state, lambda p, o: TPPO.ac_apply(p, o, cfg.activation)[0])
    assert got["final_key"] == want["final_key"]
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                       err_msg=k)
