"""The port's DQN slice against the JAX package, on the CPU.

  - `rl.networks`: `mlp_init`/`cnn_init` against JAX's (their normals are
    within 3 ulps, tests/test_torch_random.py), `mlp_apply` under all four
    activations and `cnn_apply` on (H, W) and (N, H, W) frames with JAX's
    params carried across (`params_from_numpy`), the 1-frame refusal;
  - `rl.replay`: the ring across a wrap and with more transitions than
    slots, step by step; `replay_sample`'s draws exactly;
  - `_td_loss` and its gradients, three `make_learn_step` updates;
  - eight `make_train_step` steps from one JAX `DQNState` carried across
    (`state_from_numpy`), on the "vmap" and "torch" pools, under a
    TimeLimit of 5, so truncated transitions are stored as not terminal;
  - `train_host` on the interpreted CartPole, the port's `baseline_python`
    copy against the JAX package's, and the Pong-v0 pixel CNN's steps;
  - whole traces: the committed training goldens
    (tests/golden/train_dqn_*.json) through the port's `train_compiled`,
    with tests/test_train_fused.py's recipe and tolerance.

Floats are held to 1e-5/1e-6 (`conftest.assert_leaves_match`), ints, bools
and keys exactly. JAX runs in the legacy threefry layout the goldens were
made with (`jax.threefry_partitionable(False)`), and trains at most twice
here (one `train_compiled`, one `train_host`).
"""
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
from repro.core import make as jax_make
from repro.envs import baseline_python as JB
from repro.rl import dqn as JD
from repro.rl import networks as JN
from repro.rl import replay as JR
from repro_torch import random as R
from repro_torch.envs import baseline_python as TB
from repro_torch.rl import dqn as TD
from repro_torch.rl import networks as TN
from repro_torch.rl import replay as TR

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
CPU = "cpu"
legacy = lambda: jax.threefry_partitionable(False)
# jitted once per shape: the JAX references' compiles are most of this
# file's time
mlp_init = jax.jit(JN.mlp_init, static_argnums=1)
cnn_init = jax.jit(JN.cnn_init, static_argnums=(1,), static_argnames="out")
cnn_apply = jax.jit(JN.cnn_apply)
replay_add = jax.jit(JR.replay_add_batch)
replay_sample = jax.jit(JR.replay_sample, static_argnums=2)


def _tkey(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _numpy(x: torch.Tensor) -> np.ndarray:
    """A port leaf as the JAX package holds it: keys (the port's only int64
    leaves) as uint32."""
    a = x.detach().numpy()
    return a.astype(np.uint32) if x.dtype == R.KEY_DTYPE else a


def _match(want, got, what):
    """`got` (the port's tree) against `want` (JAX's), NamedTuples by field
    name, dicts by key, lists by position, leaves by the parity contract."""
    if isinstance(got, tuple):
        assert got._fields == want._fields, what
        for f in got._fields:
            _match(getattr(want, f), getattr(got, f), f"{what}.{f}")
    elif isinstance(got, dict):
        assert sorted(got) == sorted(want), what
        for k in got:
            _match(want[k], got[k], f"{what}[{k}]")
    elif isinstance(got, list):
        assert len(got) == len(want), what
        for i, (w, g) in enumerate(zip(want, got)):
            _match(w, g, f"{what}[{i}]")
    else:
        assert_leaves_match(np.asarray(want), _numpy(got), what)


def _carry(params):
    return TD.params_from_numpy(jax.tree.map(np.asarray, params), CPU)


# -- networks -------------------------------------------------------------------

@pytest.mark.parametrize("activation", ("elu", "relu", "tanh", "gelu"))
def test_mlp_init_and_apply(activation):
    sizes = (4, 16, 16, 3)
    with legacy():
        jparams = mlp_init(jax.random.PRNGKey(1), sizes)
    _match(jparams, TN.mlp_init(R.PRNGKey(1), sizes), "mlp_init")
    x = (2 * np.random.default_rng(0).standard_normal((7, 4))).astype(np.float32)
    want = JN.mlp_apply(jparams, jnp.asarray(x), activation)
    got = TN.mlp_apply(_carry(jparams), torch.from_numpy(x), activation)
    _match(want, got, f"mlp_apply[{activation}]")


@pytest.mark.parametrize("in_shape", ((36, 36), (4, 36, 36)))
def test_cnn_init_and_apply(in_shape):
    with legacy():
        jparams = cnn_init(jax.random.PRNGKey(2), in_shape, out=3)
    _match(jparams, TN.cnn_init(R.PRNGKey(2), in_shape, out=3), "cnn_init")
    x = np.random.default_rng(1).uniform(0, 1, (2, 3) + in_shape)
    x = x.astype(np.float32)
    want = cnn_apply(jparams, jnp.asarray(x))
    got = TN.cnn_apply(_carry(jparams), torch.from_numpy(x))
    assert tuple(got.shape) == (2, 3, 3)
    _match(want, got, f"cnn_apply{in_shape}")


def test_cnn_refuses_ambiguous_and_bad_shapes():
    with pytest.raises(ValueError, match="1-frame stacks are ambiguous"):
        TN.cnn_init(R.PRNGKey(0), (1, 36, 36))
    with pytest.raises(ValueError, match=r"\(H, W\) or \(N, H, W\)"):
        TN.cnn_init(R.PRNGKey(0), (36,))


# -- replay ---------------------------------------------------------------------

def _transitions(rng, b, obs_dim=3):
    return (rng.standard_normal((b, obs_dim)).astype(np.float32),
            rng.integers(0, 4, b).astype(np.int32),
            rng.standard_normal(b).astype(np.float32),
            rng.standard_normal((b, obs_dim)).astype(np.float32),
            rng.integers(0, 2, b).astype(bool))


def test_replay_add_wraps_and_truncates():
    """Batches of 2, 2, 3 (a wrap) and 7 > cap = 5 (the head dropped, ptr
    advanced by all 7), each state against JAX's."""
    rng = np.random.default_rng(2)
    jstate = JR.replay_init(5, (3,))
    tstate = TR.replay_init(5, (3,), device=CPU)
    for b in (2, 2, 3, 7):
        batch = _transitions(rng, b)
        jstate = replay_add(jstate, *batch)
        tstate = TR.replay_add_batch(tstate, *map(torch.from_numpy, batch))
        _match(jstate, tstate, f"ring after a batch of {b}")


@pytest.mark.parametrize("size", (0, 3, 96))
def test_replay_sample_draws_as_jax(size):
    """The traced `max(size, 1)` bound draws JAX's indices: the sampled
    rows are equal bit for bit."""
    rng = np.random.default_rng(3)
    jstate = JR.replay_init(96, (3,))
    tstate = TR.replay_init(96, (3,), device=CPU)
    if size:
        batch = _transitions(rng, size)
        jstate = replay_add(jstate, *batch)
        tstate = TR.replay_add_batch(tstate, *map(torch.from_numpy, batch))
    for seed in range(3):
        with legacy():
            key = jax.random.PRNGKey(seed)
            want = replay_sample(jstate, key, 32)
        got = TR.replay_sample(tstate, _tkey(key), 32)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(_numpy(g), np.asarray(w))


# -- the learner ----------------------------------------------------------------

CFG = dict(num_envs=2, memory_size=12, learn_start=4, batch_size=4,
           exploration_steps=6, target_update_freq=3, units=(16, 16))


def _learner_case(seed):
    """JAX MLP params and target for CartPole's 4 -> 2, and a batch."""
    rng = np.random.default_rng(seed)
    with legacy():
        kp, kt = jax.random.split(jax.random.PRNGKey(seed))
        params = mlp_init(kp, (4, 16, 16, 2))
        target = mlp_init(kt, (4, 16, 16, 2))
    obs, action, reward, next_obs, done = _transitions(rng, 8, 4)
    action = action % 2
    return params, target, (obs, action, reward, next_obs,
                            done.astype(np.float32))


def _apply(params, x):
    return (JN.mlp_apply if isinstance(x, jax.Array) else TN.mlp_apply)(
        params, x, "elu")


def test_td_loss_and_gradients():
    params, target, batch = _learner_case(4)
    jbatch = tuple(map(jnp.asarray, batch))
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: JD._td_loss(_apply, p, target, jbatch, 0.99)))(params)
    tbatch = tuple(map(torch.from_numpy, batch))
    tparams, ttarget = _carry(params), _carry(target)
    got_loss, got_grads = TD.value_and_grad(
        lambda p: TD._td_loss(_apply, p, ttarget, tbatch, 0.99), tparams)
    _match(want_loss, got_loss, "td loss")
    _match(want_grads, got_grads, "td grads")


def test_learn_step_three_updates():
    """Three Adam updates through each package's learner, params and
    optimizer state threaded through each side's own updates."""
    params, target, _ = _learner_case(5)
    cfg = JD.DQNConfig(**CFG)
    jlearn = jax.jit(JD.make_learn_step(_apply, cfg))
    tlearn = TD.make_learn_step(_apply, TD.DQNConfig(**CFG))
    jp, jopt = params, JD.Adam(lr=cfg.lr).init(params)
    tp = _carry(params)
    topt = TD.Adam(lr=cfg.lr).init(tp)
    ttarget = _carry(target)
    for i in range(3):
        batch = _learner_case(10 + i)[2]
        jp, jopt, jloss = jlearn(jp, target, jopt, tuple(map(jnp.asarray,
                                                              batch)))
        tp, topt, tloss = tlearn(tp, ttarget, topt,
                                 tuple(map(torch.from_numpy, batch)))
        _match(jloss, tloss, f"loss, update {i}")
        _match(jp, tp, f"params, update {i}")
        _match(jopt, topt, f"adam state, update {i}")


TRAIN_STEPS, LIMIT = 8, 5


@pytest.fixture(scope="module")
def jax_run():
    """JAX's initial state and its state and metrics after 8 steps, on
    CartPole under a TimeLimit of 5: `train_compiled`'s init and scan, the
    init jitted too (JAX's eager init costs seconds more)."""
    env = JP.build_pipeline(JC.CartPole(), (JP.TimeLimit(LIMIT),))
    cfg = JD.DQNConfig(**CFG)
    apply_fn = {}

    def init(key):
        state, apply_fn["mlp"] = JD.dqn_init(env, cfg, key)
        return state

    with legacy():
        state0 = jax.jit(init)(jax.random.PRNGKey(7))
        step_fn = JD.make_train_step(env, apply_fn["mlp"], cfg)
        state, metrics = jax.jit(lambda s: jax.lax.scan(
            step_fn, s, None, length=TRAIN_STEPS))(state0)
    return (jax.tree.map(np.asarray, state0), jax.tree.map(np.asarray, state),
            jax.tree.map(np.asarray, metrics))


@pytest.mark.parametrize("backend", ("vmap", "torch"))
def test_train_step_from_a_carried_state(jax_run, backend):
    """Eight port steps from JAX's initial state give JAX's state after
    eight: params, target, Adam, the ring (truncations stored as not
    terminal), the pool carry and the key chain."""
    state0, want, want_metrics = jax_run
    env = TP.build_pipeline(TC.CartPole(), (TP.TimeLimit(LIMIT),))
    cfg = TD.DQNConfig(**CFG, env_backend=backend)
    state = TD.state_from_numpy(state0, env, cfg, CPU)
    _match(state0, state, "carried initial state")
    _, apply_fn = TD._build_net(env, cfg, R.PRNGKey(0))
    step_fn = TD.make_train_step(env, apply_fn, cfg, CPU)
    metrics = []
    for _ in range(TRAIN_STEPS):
        state, m = step_fn(state)
        metrics.append(m)
    _match(want, state, f"state after {TRAIN_STEPS} steps ({backend})")
    for k, v in want_metrics.items():
        _match(v, torch.stack([m[k] for m in metrics]), f"metrics[{k}]")
    # the time limit cut episodes, and a cut is not stored as terminal
    assert state.pool.env_state.inner.t.max() < LIMIT
    assert float(state.replay.done.sum()) < TRAIN_STEPS * CFG["num_envs"]


def test_train_host_matches_jax():
    """The Gym execution model: the interpreted CartPole (each package's
    copy) with the same seed; the episode returns exactly, the params at
    the parity contract (the port draws its own init, within ulps)."""
    kw = dict(memory_size=64, learn_start=8, batch_size=8,
              exploration_steps=20, target_update_freq=10, units=(16, 16))
    with legacy():
        key = jax.random.PRNGKey(11)
        want_params, want_returns = JD.train_host(
            JB.CartPolePy, jax_make("CartPole-v1"), JD.DQNConfig(**kw), 40,
            key, seed=3)
    got_params, got_returns = TD.train_host(
        TB.CartPolePy, repro_torch.make("CartPole-v1"), TD.DQNConfig(**kw), 40,
        _tkey(key), seed=3, device=CPU)
    assert got_returns == want_returns and len(got_returns) >= 1
    _match(want_params, got_params, "train_host params")


@pytest.mark.parametrize("name", sorted(TB.BASELINES))
def test_baseline_python_copy_matches_jax(name):
    """Same seed, same actions: the same interpreted trajectory."""
    envs = [pkg.BASELINES[name]() for pkg in (JB, TB)]
    rng = np.random.default_rng(9)
    n = envs[0].n_actions
    actions = (rng.integers(0, n, 120) if n else
               rng.uniform(-2, 2, (120, 1)).astype(np.float32))
    for env in envs:
        env.seed(5)
    for t, a in enumerate(actions):
        outs = []
        for env in envs:
            if t % 40 == 0:
                outs.append(env.reset())
            else:
                obs, rew, done, info = env.step(a.tolist())
                outs.append((obs, rew, done, sorted(info.items())))
        np.testing.assert_equal(outs[1], outs[0], err_msg=f"{name}, step {t}")
    if n:
        assert envs[1].action_space_sample() == envs[0].action_space_sample()


def test_cnn_dqn_steps_on_pong_pixels():
    """The pixel CNN on Pong-v0's 4×84×84 frame stacks through the fused
    plain pool: replay rows are frame stacks, the loss is finite."""
    cfg = TD.DQNConfig(network="cnn", memory_size=8, batch_size=2,
                       num_envs=2, learn_start=2, env_backend="torch")
    state, apply_fn, metrics = TD.train_compiled(
        repro_torch.make("Pong-v0"), cfg, 3, R.PRNGKey(0), device=CPU)
    assert tuple(state.replay.obs.shape) == (8, 4, 84, 84)
    assert int(state.replay.size) == 6 and int(state.opt.step) == 3
    assert float(state.replay.obs[:6].sum()) > 0
    assert torch.isfinite(metrics["loss"]).all()
    assert tuple(apply_fn(state.params, state.pool.obs).shape) == (2, 3)


# -- whole traces: the committed training goldens -----------------------------

#: src/repro/train/fused.py::golden_train_setup's DQN recipe
GOLDEN_CFG = dict(num_envs=2, memory_size=96, learn_start=16, batch_size=8,
                  exploration_steps=48, target_update_freq=13)
EXACT = ("final_key", "replay_ptr", "replay_size", "replay_done_sum")


@pytest.mark.parametrize("gid, backend", (("dqn/CartPole-v1", "torch"),
                                          ("dqn/FrozenLake-v0", "vmap")))
def test_golden_train_trace(gid, backend):
    """One golden on each of the CPU's pools: the plain megastep (the CUDA
    kernel's twin) and the vmap pool the goldens were made with."""
    want = json.loads((GOLDEN_DIR / f"train_{gid.replace('/', '_')}.json")
                      .read_text())
    env = repro_torch.make(gid.split("/")[1])
    cfg = TD.DQNConfig(**GOLDEN_CFG, env_backend=backend)
    state, apply_fn, metrics = TD.train_compiled(
        env, cfg, 64, R.PRNGKey(sum(map(ord, gid))), chunk=13, device=CPU)
    assert tuple(metrics["loss"].shape) == (64,)
    got = TD.golden_checksums(env, state, apply_fn)
    for k in EXACT:
        assert got[k] == want[k], (gid, k, got[k], want[k])
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{gid}.{k}")
