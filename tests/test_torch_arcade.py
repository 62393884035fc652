"""The port's arcade slice against the JAX package: Pong and Breakout, the
pixel wrappers and the pixel branch of the fused step.

  - `random.bernoulli` bit for bit against `jax.random.bernoulli`;
  - Pong and Breakout `reset`, `step`, `scene` and `render` against the
    vmapped JAX envs, their fused `step_rows` and derived row layout against
    the JAX specs, from numpy-seeded states (balls at the paddles, in the
    brick region over random boards);
  - the pixel `fused_step` (backend "torch") against JAX `fused_step`
    (backend "jnp") on `Pong-v0` and `Breakout-v0` at B = 3, K = 4, from
    states where an episode ends, a brick breaks and a time limit cuts;
  - the four arcade goldens (tests/golden/) replayed through the port's
    `make_vec(id, B, device="cpu")` on backends "vmap" and "auto" (the plain
    megastep and rasteriser), at the goldens' 1e-4.

Ints, bools and keys exact; floats to rtol 1e-5 / atol 1e-6
(tests/conftest.py::assert_leaves_match), rendered frames to rtol 1e-5 /
atol 1e-5 (FRAME_ATOL, for the reason given there). The JAX side runs in
the legacy threefry layout the goldens were made with.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.envs.arcade as J
import repro_torch
import repro_torch.envs.arcade as T
from repro.core.registry import make as jax_make
from repro.core.wrappers import AutoReset as JAutoReset
from repro.core.wrappers import Vec as JVec
from repro.kernels.envstep import fused_step as jax_fused_step
from repro.kernels.envstep import spec_for as jax_spec_for
from repro_torch import random as R
from repro_torch.core.registry import make
from repro_torch.core.spaces import sample_batch
from repro_torch.core.wrappers import AutoReset, Vec
from repro_torch.kernels.envstep import fused_step, spec_for
from repro_torch.pool.envpool import _load_like


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
ENVS = ("Pong", "Breakout")
B = 8
#: float atol of rendered frames. Under jit and vmap, XLA's CPU backend
#: contracts some of the rasteriser's multiply-adds (`x0 + t*dx`, the dot
#: product) into FMAs, and the port rounds every op apart; near a capsule's
#: edge the distance cancels, and the soft edge multiplies it by
#: 1/softness = 84, so single pixels differ by a few 1e-6. The JAX package
#: holds its own Pallas rasteriser against its oracle at atol 1e-5
#: (tests/test_kernels.py::test_raster_matches_ref); so does this file.
#: tests/test_torch_raster.py holds the plain rasteriser to the unjitted
#: oracle at 1e-6.
FRAME_ATOL = 1e-5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _match(want, got, what="", atol=1e-6):
    want, got = np.asarray(want), _np(got)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got.astype(want.dtype), want,
                                      err_msg=what)
        assert got.dtype == want.dtype or want.dtype == np.uint32, (
            what, got.dtype, want.dtype)
    else:
        assert got.dtype == np.float32, (what, got.dtype)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol,
                                   err_msg=what)


def _match_tree(want, got, what):
    if isinstance(got, tuple):
        assert got._fields == want._fields, what
        for f in got._fields:
            _match_tree(getattr(want, f), getattr(got, f), f"{what}.{f}")
    else:
        _match(want, got, what,
               FRAME_ATOL if what.endswith(".frames") else 1e-6)


def _keys(seed, n=B):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)


def _states(name, seed, n=B):
    """numpy-seeded core states, field by field: Pong balls near both
    paddle planes and edges, Breakout balls in and around the brick region
    over random boards. Lane 0 scores (Pong) or breaks the last brick and
    clears the board (Breakout); Breakout's lane 1 drops the ball."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)
    sign = lambda: np.where(rng.random(n) < 0.5, -1, 1).astype(np.float32)
    if name == "Pong":
        vals = [np.where(rng.random(n) < 0.5, u(0.0, 0.12), u(0.88, 1.0)),
                u(0.0, 1.0), sign() * np.float32(0.035), u(-0.05, 0.05),
                u(0.12, 0.88), u(0.12, 0.88)]
        for v, x in zip(vals, (0.99, 0.9, 0.035, 0.0, 0.12, 0.5)):
            v[0] = x
        return vals
    bricks = (rng.random((n, 4, 6)) < 0.6).astype(np.int32)
    bricks[0] = 0
    bricks[0, 1, 2] = 1     # the last brick, under lane 0's ball
    vals = [u(0.0, 1.0), u(0.1, 0.35), u(-0.04, 0.04),
            sign() * u(0.02, 0.04), u(0.14, 0.86), bricks]
    for i, lane in enumerate(((0.42, 0.19, 0.0, 0.005, 0.5),
                              (0.5, 0.99, 0.0, 0.03, 0.14))):
        for v, x in zip(vals, lane):
            v[i] = x
    return vals


def _state_pair(name, seed, n=B):
    vals = _states(name, seed, n)
    jcls = type(jax.eval_shape(getattr(J, name)().reset,
                               jax.random.PRNGKey(0))[0])
    tcls = type(getattr(T, name)().reset(torch.zeros(1, 2, dtype=torch.int64))[0])
    return (jcls(*map(jnp.asarray, vals)), tcls(*map(torch.from_numpy, vals)))


def test_bernoulli_bit_exact():
    keys = _keys(0, 64)
    tkeys = torch.from_numpy(keys.astype(np.int64))
    with jax.threefry_partitionable(False):
        for p, shape in ((0.5, ()), (0.5, (7,)), (0.3, (3, 2)), (0.9, ())):
            want = jax.vmap(lambda k: jax.random.bernoulli(k, p, shape))(
                jnp.asarray(keys))
            got = R.bernoulli(tkeys, p, shape)
            assert got.dtype == torch.bool
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ENVS)
def test_reset_matches_jax(name):
    keys = _keys(1)
    with jax.threefry_partitionable(False):
        want_state, want_obs = jax.vmap(getattr(J, name)().reset)(
            jnp.asarray(keys))
    state, obs = getattr(T, name)().reset(torch.from_numpy(keys.astype(np.int64)))
    _match_tree(want_state, state, name)
    _match(want_obs, obs, f"{name} obs")


@pytest.mark.parametrize("name", ENVS)
def test_step_matches_jax(name):
    jenv, tenv = getattr(J, name)(), getattr(T, name)()
    jstate, tstate = _state_pair(name, 2)
    act = np.random.default_rng(3).integers(0, 3, B).astype(np.int32)
    with jax.threefry_partitionable(False):
        want = jax.vmap(jenv.step)(jstate, jnp.asarray(act),
                                   jax.random.split(jax.random.PRNGKey(0), B))
    got = tenv.step(tstate, torch.from_numpy(act))
    _match_tree(want.state, got.state, name)
    for what in ("obs", "reward", "done"):
        _match(getattr(want, what), getattr(got, what), f"{name} {what}")
    assert got.done.any(), "the states must end an episode"
    if name == "Breakout":
        assert (got.reward >= 1).any(), "a brick must break"


@pytest.mark.parametrize("name", ENVS)
def test_scene_and_render_match_jax(name):
    jenv, tenv = getattr(J, name)(), getattr(T, name)()
    jstate, tstate = _state_pair(name, 4, n=3)
    want_segs, want_int = jax.vmap(jenv.scene)(jstate)
    segs, intens = tenv.scene(tstate)
    _match(want_segs, segs, f"{name} segs")
    _match(want_int, intens, f"{name} intens")
    _match(jax.vmap(jenv.render)(jstate), tenv.render(tstate),
           f"{name} frames", FRAME_ATOL)


@pytest.mark.parametrize("name", ENVS)
def test_step_rows_and_layout_match_jax(name):
    jspec, spec = jax_spec_for(getattr(J, name)()), spec_for(getattr(T, name)())
    assert (spec.state_size, spec.obs_size, spec.obs_is_state) == (
        jspec.state_size, jspec.obs_size, jspec.obs_is_state)
    jstate, tstate = _state_pair(name, 5)
    rows = spec.flatten(tstate)
    _match(jspec.flatten(jstate), rows, f"{name} rows")
    back = spec.unflatten(rows)
    for a, b in zip(tstate, back):     # int32 bricks survive the f32 rows
        assert a.dtype == b.dtype and torch.equal(a, b)
    act = np.random.default_rng(6).integers(0, 3, (1, B)).astype(np.float32)
    want = jspec.step_rows(jnp.asarray(rows.numpy()), jnp.asarray(act))
    new, obs, reward, done = spec.step_rows(rows, torch.from_numpy(act[0]))
    _match(want[0], new, f"{name} new rows")
    _match(want[1], obs, f"{name} obs rows")
    _match(np.asarray(want[2])[0], reward, f"{name} reward row")
    _match(np.asarray(want[3])[0], done, f"{name} done row")


def _with_core(state, core_fn, t):
    """`AutoResetState(FrameStackState(TimeLimitState(core, t), frames))`
    with the core state and step counter replaced."""
    fs = state.inner
    tl = fs.inner
    return state._replace(inner=fs._replace(
        inner=tl._replace(inner=core_fn(tl.inner), t=t)))


@pytest.mark.parametrize("name", ENVS)
def test_pixel_fused_step_matches_jax(name):
    """`FrameStack(ObsToPixels(TimeLimit(core)))` through the fused step:
    the plain megastep, two plain raster calls and the frame-stack ring,
    against JAX's jnp fused step."""
    b, k = 3, 4
    env_id = f"{name}-v0"
    vals = _states(name, 7, n=b)
    t = np.full(b, 997, np.int32)   # lanes still running at step 3 are cut
    acts = np.random.default_rng(8).integers(0, 3, (k, b)).astype(np.int32)
    with jax.threefry_partitionable(False):
        jenv = jax_make(env_id)
        js, _ = jax.jit(JVec(JAutoReset(jenv), b).reset)(
            jax.random.PRNGKey(9))
        js = _with_core(js, lambda c: type(c)(*map(jnp.asarray, vals)),
                        jnp.asarray(t))
        jnew, jts = jax.jit(lambda s, a: jax_fused_step(
            jenv, s, a, backend="jnp"))(js, jnp.asarray(acts))
    env = make(env_id)
    ts_state, _ = Vec(AutoReset(env), b).reset(R.PRNGKey(9, "cpu"))
    ts_state = _load_like(ts_state, js, "cpu")
    new, ts = fused_step(env, ts_state, torch.from_numpy(acts),
                         backend="torch")
    _match_tree(jnew, new, f"{env_id} state")
    assert new.inner.frames.shape == (b, 4, 84, 84)
    _match(jts.obs, ts.obs, f"{env_id} obs", FRAME_ATOL)
    _match(jts.info["terminal_obs"], ts.info["terminal_obs"],
           f"{env_id} terminal_obs", FRAME_ATOL)
    for what in ("reward", "done"):
        _match(getattr(jts, what), getattr(ts, what), f"{env_id} {what}")
    _match(jts.info["truncated"], ts.info["truncated"], f"{env_id} truncated")
    assert ts.done.any() and ts.info["truncated"].any()
    if name == "Breakout":
        assert (ts.reward >= 1).any(), "a brick must break inside K"


@pytest.mark.parametrize("backend", ("vmap", "auto"))
@pytest.mark.parametrize("name", ("Pong-v0", "Pong-raw", "Breakout-v0",
                                  "Breakout-raw"))
def test_arcade_goldens_through_make_vec(name, backend):
    """tests/test_envspec.py::_pool_trace, through the port."""
    want = json.loads((GOLDEN_DIR / f"{name}.json").read_text())
    batch = want["batch"]
    pool = repro_torch.make_vec(name, batch, backend=backend, device="cpu")
    assert pool.backend == ("torch" if backend == "auto" else "vmap")
    handle = pool.xla()
    key = R.PRNGKey(sum(map(ord, name)), "cpu")
    ps = handle.init(key)
    assert tuple(ps.obs.shape[1:]) == tuple(want.get("obs_shape",
                                                     ps.obs.shape[1:]))
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
