"""The port's classic-control envs and fused specs against the JAX package.

For CartPole, MountainCar, Pendulum and Acrobot: `reset` from the same keys,
one `step` from the same numpy-seeded states and actions (wide enough that
episodes end, speeds clamp and angles wrap), the fused `step_rows`, and the
derived row layout; and the capsule `scene` and `render` behind
`rollout(render=True)`. The derived layout of the five grid and puzzle
bodies too, Snake's field order included. Ints and bools exact; floats to rtol 1e-5 / atol
1e-6 (tests/conftest.py::assert_leaves_match), rendered frames to atol
1e-5 (tests/test_torch_arcade.py::FRAME_ATOL says why). The JAX side runs in the legacy
threefry layout the goldens were made with.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.envs.classic as J
import repro.envs.grid as JG
import repro.envs.puzzle as JP
import repro_torch.envs.classic as T
import repro_torch.envs.grid as TG
import repro_torch.envs.puzzle as TP
from repro.kernels.envstep import spec_for as jax_spec_for
from repro_torch.kernels.envstep import spec_for


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B = 8
ENVS = ("CartPole", "MountainCar", "Pendulum", "Acrobot")
STATE_RANGES = {
    "CartPole": [(-2.4, 2.4), (-2.0, 2.0), (-0.21, 0.21), (-2.0, 2.0)],
    "MountainCar": [(-1.2, 0.6), (-0.07, 0.07)],
    "Pendulum": [(-3 * math.pi, 3 * math.pi), (-8.0, 8.0)],
    "Acrobot": [(-math.pi, math.pi), (-math.pi, math.pi),
                (-4 * math.pi, 4 * math.pi), (-9 * math.pi, 9 * math.pi)],
}


def _match(want, got, what=""):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got.dtype == np.float32, (what, got.dtype)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=what)


def _inputs(name, seed):
    rng = np.random.default_rng(seed)
    rows = np.stack([rng.uniform(lo, hi, B) for lo, hi in STATE_RANGES[name]]
                    ).astype(np.float32)
    if name == "Pendulum":
        act = rng.uniform(-3.0, 3.0, (B, 1)).astype(np.float32)
    else:
        act = rng.integers(0, 2 if name == "CartPole" else 3, B).astype(np.int32)
    return rows, act


def _keys(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (B, 2), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("name", ENVS)
def test_reset_matches_jax(name):
    keys = _keys(1)
    with jax.threefry_partitionable(False):
        want_state, want_obs = jax.vmap(getattr(J, name)().reset)(
            jnp.asarray(keys))
    state, obs = getattr(T, name)().reset(torch.from_numpy(keys.astype(np.int64)))
    assert state._fields == want_state._fields
    for f in state._fields:
        _match(getattr(want_state, f), getattr(state, f), f"{name}.{f}")
    _match(want_obs, obs, f"{name} obs")


@pytest.mark.parametrize("name", ENVS)
def test_step_matches_jax(name):
    rows, act = _inputs(name, 2)
    jenv, tenv = getattr(J, name)(), getattr(T, name)()
    with jax.threefry_partitionable(False):
        jstate = type(jax.eval_shape(jenv.reset, jax.random.PRNGKey(0))[0])(
            *jnp.asarray(rows))
        want = jax.vmap(jenv.step)(jstate, jnp.asarray(act),
                                   jax.random.split(jax.random.PRNGKey(0), B))
    state = type(tenv.reset(torch.zeros(1, 2, dtype=torch.int64))[0])(
        *torch.from_numpy(rows))
    got = tenv.step(state, torch.from_numpy(act))
    for f in got.state._fields:
        _match(getattr(want.state, f), getattr(got.state, f), f"{name}.{f}")
    _match(want.obs, got.obs, f"{name} obs")
    _match(want.reward, got.reward, f"{name} reward")
    _match(want.done, got.done, f"{name} done")


@pytest.mark.parametrize("name", ENVS)
def test_step_rows_match_jax(name):
    rows, act = _inputs(name, 3)
    act_rows = act.reshape(1, B).astype(np.float32)
    jspec, spec = jax_spec_for(getattr(J, name)()), spec_for(getattr(T, name)())
    want = jspec.step_rows(jnp.asarray(rows), jnp.asarray(act_rows))
    new, obs, reward, done = spec.step_rows(torch.from_numpy(rows),
                                            torch.from_numpy(act_rows[0]))
    _match(want[0], new, f"{name} rows")
    _match(want[1], obs, f"{name} obs rows")
    _match(np.asarray(want[2])[0], reward, f"{name} reward row")
    _match(np.asarray(want[3])[0], done, f"{name} done row")


def _any_env(name, jax_side):
    """A classic, grid or puzzle env of either package."""
    mod = next(m for m in ((J, JG, JP) if jax_side else (T, TG, TP))
               if hasattr(m, name))
    return getattr(mod, name)()


@pytest.mark.parametrize("name", ENVS + ("LightsOut", "FrozenLake",
                                         "CliffWalk", "Maze", "Snake"))
def test_derived_layout_matches_jax(name):
    """Sizes, the rows of the same reset state (field order included) and
    the round trip back to the state."""
    jenv, env = _any_env(name, True), _any_env(name, False)
    jspec, spec = jax_spec_for(jenv), spec_for(env)
    assert (spec.state_size, spec.obs_size) == (jspec.state_size,
                                                jspec.obs_size)
    keys = _keys(4)
    with jax.threefry_partitionable(False):
        want = jspec.flatten(jax.vmap(jenv.reset)(jnp.asarray(keys))[0])
    state, _ = env.reset(torch.from_numpy(keys.astype(np.int64)))
    rows = spec.flatten(state)
    _match(want, rows, f"{name} rows")
    assert rows.shape == (spec.state_size, B) and rows.dtype == torch.float32
    back = spec.unflatten(rows)
    assert type(back) is type(state)
    for a, b in zip(state, back):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ENVS)
def test_scene_and_render_match_jax(name):
    rows, _ = _inputs(name, 5)
    jenv, tenv = getattr(J, name)(), getattr(T, name)()
    jstate = type(jax.eval_shape(jenv.reset, jax.random.PRNGKey(0))[0])(
        *jnp.asarray(rows))
    state = type(tenv.reset(torch.zeros(1, 2, dtype=torch.int64))[0])(
        *torch.from_numpy(rows))
    want_segs, want_int = jax.vmap(jenv.scene)(jstate)
    segs, intens = tenv.scene(state)
    _match(want_segs, segs, f"{name} segs")
    _match(want_int, intens, f"{name} intens")
    want = np.asarray(jax.vmap(jenv.render)(jstate))
    got = tenv.render(state)
    assert got.shape == (B, 84, 84) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                               err_msg=f"{name} frames")
