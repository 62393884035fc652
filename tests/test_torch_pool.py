"""The port's classic-control slice as a whole against the JAX package.

  - the committed golden traces (tests/golden/), replayed through the port's
    `make_vec(id, 2, device="cpu").xla()` with the
    tests/test_envspec.py::_pool_trace recipe, at the goldens' 1e-4;
  - `rollout` and the stateful `step` (key chain included) against JAX
    `make_vec(id, 8, backend="jnp", unroll=8)`;
  - a JAX `EnvPool.state_dict()` loaded into the port, both pools then
    stepping alike, and the port's own snapshot in the JAX structure; also
    for the pixel id `Pong-v0`, whose snapshot holds a `FrameStackState`;
  - `rollout(render=True)` against the JAX pool's last frame.

The JAX side builds and runs inside `jax.threefry_partitionable(False)`,
the layout the goldens were made with. The per-step keys reach the envs
as in the JAX pool; Multitask, whose dynamics read them, is held to the JAX
pool in tests/test_torch_grid.py.
"""
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

import repro_torch
from repro.pool import make_vec as jax_make_vec
from repro_torch import random as R
from repro_torch.core.spaces import sample_batch


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
CLASSIC = ("CartPole-v1", "MountainCar-v0", "Pendulum-v1", "Acrobot-v1")
GOLDEN_IDS = CLASSIC + ("CartPole-raw", "MountainCar-raw", "Pendulum-raw",
                        "Acrobot-raw")
B, UNROLL, ROLLOUT_STEPS, STATEFUL_STEPS = 8, 8, 20, 12
#: float atol of rendered frames: the JAX rasteriser under jit contracts
#: some multiply-adds, the port rounds every op apart, and the soft edge
#: multiplies the difference by H = 84 (tests/test_torch_arcade.py says
#: more); the JAX package's own raster tests hold at 1e-5 too.
FRAME_ATOL = 1e-5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _match(want, got, what):
    want, got = np.asarray(want), _np(got)
    assert want.shape == got.shape and want.dtype == got.dtype, (
        what, want.shape, got.shape, want.dtype, got.dtype)
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _match_tree(want, got, what):
    if isinstance(got, tuple):
        assert got._fields == want._fields, what
        for f in got._fields:
            _match_tree(getattr(want, f), getattr(got, f), f"{what}.{f}")
    elif isinstance(got, dict):
        assert sorted(got) == sorted(want), what
        for k in got:
            _match_tree(want[k], got[k], f"{what}[{k}]")
    else:
        _match(want, got, what)


@pytest.mark.parametrize("backend", ("vmap", "auto"))
@pytest.mark.parametrize("name", GOLDEN_IDS)
def test_goldens_through_make_vec(name, backend):
    want = json.loads((GOLDEN_DIR / f"{name}.json").read_text())
    batch = want["batch"]
    pool = repro_torch.make_vec(name, batch, backend=backend, device="cpu")
    assert pool.backend == ("torch" if backend == "auto" else "vmap")
    handle = pool.xla()
    key = R.PRNGKey(sum(map(ord, name)), "cpu")
    ps = handle.init(key)
    np.testing.assert_allclose(float(ps.obs.double().sum()),
                               want["reset_obs_sum"], rtol=1e-4, atol=1e-4)
    rows = []
    for t in range(want["steps"]):
        a = sample_batch(pool.action_space, R.fold_in(key, 1000 + t), batch)
        ps, out = handle.step(ps, a, R.fold_in(key, t))
        rows.append([float(out.obs.double().sum()),
                     float(out.reward.double().sum()), int(out.done.sum())])
    np.testing.assert_allclose(np.asarray(rows), np.asarray(want["rows"]),
                               rtol=1e-4, atol=1e-4,
                               err_msg=f"{name} ({backend}) left its golden")


@pytest.mark.parametrize("name", CLASSIC)
def test_rollout_matches_jax(name):
    with jax.threefry_partitionable(False):
        jpool = jax_make_vec(name, B, backend="jnp", unroll=UNROLL)
        j_rew, j_eps, _ = jpool.rollout(ROLLOUT_STEPS, jax.random.PRNGKey(4))
    for backend in ("torch", "vmap"):
        pool = repro_torch.make_vec(name, B, backend=backend, unroll=UNROLL,
                                    device="cpu")
        rew, eps, _ = pool.rollout(ROLLOUT_STEPS, R.PRNGKey(4, "cpu"))
        _match(j_eps, eps, f"{name} {backend} episodes")
        _match(j_rew, rew, f"{name} {backend} sum_reward")


@pytest.mark.parametrize("name", CLASSIC)
def test_stateful_step_and_snapshot_match_jax(name):
    pool = repro_torch.make_vec(name, B, backend="torch", device="cpu")
    with jax.threefry_partitionable(False):
        jpool = jax_make_vec(name, B, backend="jnp")
        _match(jpool.reset(seed=3), pool.reset(seed=3), f"{name} reset obs")
        for t in range(STATEFUL_STEPS):
            ja, a = jpool.sample_actions(seed=t), pool.sample_actions(seed=t)
            _match(ja, a, f"{name} actions {t}")
            want, got = jpool.step(ja), pool.step(a)
            for i, what in enumerate(("obs", "reward", "done")):
                _match(want[i], got[i], f"{name} {what} {t}")
            _match_tree(want[3], got[3], f"{name} info {t}")
        _match_tree(jpool.state_dict(), pool.state_dict(), f"{name} snapshot")


@pytest.mark.parametrize("name", CLASSIC)
def test_loads_jax_state_dict(name):
    with jax.threefry_partitionable(False):
        jpool = jax_make_vec(name, B, backend="jnp")
        jpool.reset(seed=6)
        for t in range(3):
            jpool.step(jpool.sample_actions(seed=100 + t))
        snap = jpool.state_dict()
        pool = repro_torch.make_vec(name, B, backend="vmap", device="cpu")
        pool.load_state_dict(snap)
        _match_tree(snap, pool.state_dict(), f"{name} snapshot round trip")
        for t in range(STATEFUL_STEPS):
            a = pool.sample_actions(seed=t)
            want = jpool.step(jpool.sample_actions(seed=t))
            got = pool.step(a)
            for i, what in enumerate(("obs", "reward", "done")):
                _match(want[i], got[i], f"{name} {what} {t}")


def test_loads_jax_pixel_state_dict():
    """A JAX `Pong-v0` snapshot, frame stack included, round-trips through
    the port, and both pools then step alike."""
    b = 3
    with jax.threefry_partitionable(False):
        jpool = jax_make_vec("Pong-v0", b, backend="jnp")
        jpool.reset(seed=6)
        for t in range(3):
            jpool.step(jpool.sample_actions(seed=100 + t))
        snap = jpool.state_dict()
        assert type(snap["env_state"].inner).__name__ == "FrameStackState"
        pool = repro_torch.make_vec("Pong-v0", b, backend="torch",
                                    device="cpu")
        pool.load_state_dict(snap)
        _match_tree(snap, pool.state_dict(), "Pong-v0 snapshot round trip")
        for t in range(4):
            want = jpool.step(jpool.sample_actions(seed=t))
            got = pool.step(pool.sample_actions(seed=t))
            assert got[0].shape == (b, 4, 84, 84)
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                       rtol=1e-5, atol=FRAME_ATOL)
            _match(want[1], got[1], f"Pong-v0 reward {t}")
            _match(want[2], got[2], f"Pong-v0 done {t}")


def test_load_state_dict_rejects_other_widths():
    with jax.threefry_partitionable(False):
        jpool = jax_make_vec("CartPole-v1", B, backend="jnp")
        jpool.reset(seed=0)
        snap = jpool.state_dict()
    pool = repro_torch.make_vec("CartPole-v1", B + 1, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        pool.load_state_dict(snap)


def test_unported_surfaces_raise_with_roadmap_item():
    """The surfaces that once raised naming their ROADMAP item are ported:
    `backend="async"` gives an `AsyncEnvPool`, `mesh=` a `ShardedEnvPool`
    over that tuple of devices, `host=True` a `HostPool`, and the render
    rollout the JAX pool's last frame."""
    from repro_torch.pool import AsyncEnvPool, ShardedEnvPool

    apool = repro_torch.make_vec("CartPole-v1", 2, backend="async",
                                 device="cpu")
    assert type(apool) is AsyncEnvPool and apool.num_slots == 2
    assert apool.backend == "torch" and apool.device == torch.device("cpu")
    spool = repro_torch.make_vec("CartPole-v1", 2, mesh=("cpu", "cpu"))
    assert type(spool) is ShardedEnvPool and spool.n_shards == 2
    assert spool.backend == "torch" and spool.shard_size == 1
    with pytest.raises(ValueError, match="do not apply"):
        repro_torch.make_vec("CartPole-v1", 2, backend="async",
                             mesh=("cpu",))
    host = repro_torch.make_vec("CartPole-v1", 2, host=True)
    assert type(host).__name__ == "HostPool" and len(host) == 2
    host.close()
    with jax.threefry_partitionable(False):
        j_rew, j_eps, j_frame = jax_make_vec(
            "CartPole-v1", 2, backend="jnp").rollout(
                6, jax.random.PRNGKey(0), render=True)
    pool = repro_torch.make_vec("CartPole-v1", 2, device="cpu")
    rew, eps, frame = pool.rollout(6, R.PRNGKey(0, "cpu"), render=True)
    assert frame.shape == (2, 84, 84) and float(frame.max()) > 0.5
    np.testing.assert_allclose(frame.numpy(), np.asarray(j_frame), rtol=1e-5,
                               atol=FRAME_ATOL)
    _match(j_rew, rew, "render rollout sum_reward")
    _match(j_eps, eps, "render rollout episodes")
    with pytest.raises(ValueError, match="CUDA device"):
        repro_torch.make_vec("CartPole-v1", 2, backend="cuda", device="cpu")
