"""The port's grid, puzzle and multitask slice against the JAX package.

  - LightsOut, FrozenLake, CliffWalk, Maze, Snake and Multitask: `reset`
    from the same keys, `step` from numpy-seeded states (holes, cliffs and
    goals next to the agent, snakes beside their food, a wall and their own
    body, boards one move from a win, Multitask balls and obstacles
    landing), `scene` and `render`, at B = 64;
  - `carve_path` with a goal per lane, `place_food`, `LightsOut.solve` and
    `MultiDiscrete` sampling;
  - `supports()` for the 16 ids of the slice, and the pool's `fused_step`
    handing back int32 cell codes;
  - the 16 goldens (tests/golden/) through `make_vec(id, B, device="cpu")`
    on the "vmap" and "auto" backends, at the goldens' 1e-4;
  - Multitask's `rollout` and stateful `step`, with and without an explicit
    key, against the JAX pool: the per-step keys reach its dynamics.

Ints, bools, keys and cell codes exact; floats to rtol 1e-5 / atol 1e-6
(tests/conftest.py::assert_leaves_match), which holds Multitask's bounded
uniform draws, one ulp apart from JAX in some lanes (ROADMAP C); rendered
frames to atol 1e-5 against jitted JAX (tests/test_torch_arcade.py::
FRAME_ATOL says why). The JAX side runs jitted, in the legacy threefry
layout the goldens were made with.
"""
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.envs.grid as JG
import repro_torch
import repro_torch.envs.grid as TG
from repro.core.env import supports_fused_step as jax_supports
from repro.core.registry import make as jax_make
from repro.core.registry import registered as jax_registered
from repro.core.spaces import MultiDiscrete as JMultiDiscrete
from repro.core.spaces import sample_batch as jax_sample_batch
from repro.core.wrappers import AutoReset as JAutoReset
from repro.core.wrappers import Vec as JVec
from repro.envs.grid.common import carve_path as jax_carve_path
from repro.envs.grid.snake import place_food as jax_place_food
from repro.envs.multitask import Multitask as JMultitask
from repro.envs.puzzle import LightsOut as JLightsOut
from repro.kernels.envstep import fused_step as jax_fused_step
from repro.kernels.envstep import spec_for as jax_spec_for
from repro.pool import make_vec as jax_make_vec
from repro_torch import random as R
from repro_torch.core import supports_fused_step
from repro_torch.core.registry import make
from repro_torch.core.spaces import MultiDiscrete, sample_batch
from repro_torch.core.wrappers import AutoReset, Vec
from repro_torch.envs.grid.common import carve_path
from repro_torch.envs.grid.snake import place_food
from repro_torch.envs.multitask import Multitask
from repro_torch.envs.puzzle import LightsOut
from repro_torch.kernels.envstep import fresh_rows, fused_step, spec_for
from repro_torch.pool.envpool import _load_like

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
B = 64
GRID = ("FrozenLake", "CliffWalk", "Maze", "Snake")
FUSED = ("LightsOut",) + GRID
FAMILIES = FUSED + ("Multitask",)
NEW_IDS = tuple(f"{f}-{v}" for f in FAMILIES for v in ("v0", "raw")) + tuple(
    f"{f}-px" for f in GRID)
FRAME_ATOL = 1e-5


def _env(name, jax_side):
    if name == "LightsOut":
        return JLightsOut() if jax_side else LightsOut()
    if name == "Multitask":
        return JMultitask() if jax_side else Multitask()
    return getattr(JG if jax_side else TG, name)()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _match(want, got, what, atol=1e-6):
    want, got = np.asarray(want), _np(got)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    if want.dtype.kind == "f":
        assert got.dtype == np.float32, (what, got.dtype)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got.astype(want.dtype), want,
                                      err_msg=what)
        assert got.dtype == want.dtype or want.dtype == np.uint32, (
            what, got.dtype, want.dtype)


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
        _match(want, got, what,
               FRAME_ATOL if what.endswith("frames") else 1e-6)


def _keys(seed, n=B):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)


def _tkeys(keys):
    return torch.from_numpy(keys.astype(np.int64))


# -- numpy-seeded states -------------------------------------------------------

#: Snake's cells in boustrophedon order (row 0 left to right, row 1 right to
#: left, ...): a body laid along it is a legal snake of any length.
SNAKE_PATH = [r * 6 + (c if r % 2 == 0 else 5 - c)
              for r in range(6) for c in range(6)]


def _toward(a, b, n_cols):
    """The grid action (0 left, 1 down, 2 right, 3 up) from cell a to its
    neighbour b."""
    if b == a + 1:
        return 2
    if b == a - 1:
        return 0
    return 1 if b == a + n_cols else 3


def grid_rows(name, rng, b):
    """numpy-seeded (S, b) float32 state rows of a fused grid or puzzle body
    (the layout of its FusedSpec) in the env's own form, and
    (b,) actions that step toward trouble: LightsOut boards one press from
    solved and that press; agents among holes, cliffs and walls, a third of
    them beside the goal and stepping into it; snakes of every length laid
    along `SNAKE_PATH` with their food ahead, a quarter of them one eat from
    filling the board. Lanes whose action is not steered take a random
    one."""
    act = rng.integers(0, 25 if name == "LightsOut" else 4, b)
    if name == "LightsOut":
        board = (rng.random((b, 25)) < 0.5).astype(np.float32)
        for i in range(0, b, 3):        # one press from solved
            p = int(rng.integers(0, 25))
            r, c = divmod(p, 5)
            board[i] = 0
            for rr, cc in ((r, c), (r + 1, c), (r - 1, c), (r, c + 1),
                           (r, c - 1)):
                if 0 <= rr < 5 and 0 <= cc < 5:
                    board[i, rr * 5 + cc] = 1
            act[i] = p
        t = rng.integers(0, 90, (b, 1))
        return np.concatenate([board, t], 1).T.astype(np.float32), act
    if name == "Snake":
        rows = np.zeros((76, b), np.float32)
        for i in range(b):
            length = 35 if i % 4 == 0 else int(rng.integers(1, 35))
            for j in range(length):
                rows[4 + SNAKE_PATH[j], i] = j + 1
            head = SNAKE_PATH[length - 1]
            food = SNAKE_PATH[length]
            rows[0:4, i] = head, food, length, rng.integers(0, 40)
            if i % 2 == 0:
                act[i] = _toward(head, food, 6)
        rows[40:] = rng.random((36, b))
        return rows, act
    n_rows, n_cols = (4, 12) if name == "CliffWalk" else (
        (8, 8) if name == "Maze" else (4, 4))
    m = n_rows * n_cols
    plane = rng.random((b, m)) < (0.25 if name == "CliffWalk" else 0.35)
    goal = np.full(b, m - 1)
    if name == "Maze":
        goal = rng.integers(m // 2, m, b)
    if name == "CliffWalk":
        plane[:, (n_rows - 1) * n_cols] = False     # the start
    plane[np.arange(b), goal] = False
    pos = np.empty(b, np.int64)
    for i in range(b):
        free = np.flatnonzero(~plane[i])
        free = free[free != goal[i]]
        pos[i] = rng.choice(free)
        g = goal[i]
        if i % 3 == 0:                 # beside the goal, stepping into it
            nb = [x for x in (g - 1, g + 1, g - n_cols, g + n_cols)
                  if 0 <= x < m and (x // n_cols == g // n_cols
                                     or x % n_cols == g % n_cols)]
            p = int(rng.choice(nb))
            plane[i, p] = False
            pos[i], act[i] = p, _toward(p, g, n_cols)
    lead = [pos[None]] if name != "Maze" else [pos[None], goal[None]]
    return np.concatenate(lead + [plane.T], 0).astype(np.float32), act


def _multitask_state(rng, n):
    """Multitask states with the ball and obstacle about to land."""
    u = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)
    lane = lambda: rng.integers(0, 3, n).astype(np.int32)
    return [u(0.05, 0.95), u(0.1, 0.9), u(0.85, 0.999), lane(), lane(),
            u(0.9, 0.999), rng.integers(0, 500, n).astype(np.int32)]


def _state_pair(name, seed, n=B):
    """The same numpy-seeded state as (JAX state, port state, actions)."""
    rng = np.random.default_rng(seed)
    if name == "Multitask":
        vals = _multitask_state(rng, n)
        jcls = type(jax.eval_shape(JMultitask().reset, jax.random.PRNGKey(0))[0])
        tcls = type(Multitask().reset(torch.zeros(1, 2, dtype=torch.int64))[0])
        return (jcls(*map(jnp.asarray, vals)), tcls(*map(torch.from_numpy, vals)),
                rng.integers(0, 3, n).astype(np.int32))
    rows, act = grid_rows(name, rng, n)
    jstate = jax_spec_for(_env(name, True)).unflatten(jnp.asarray(rows))
    tstate = spec_for(_env(name, False)).unflatten(torch.from_numpy(rows))
    return jstate, tstate, act.astype(np.int32)


# -- envs ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jit(name, what):
    """A jitted, vmapped JAX env method: the oracles run compiled."""
    env = _env(name, True)
    return jax.jit(jax.vmap(getattr(env, what)))


@pytest.mark.parametrize("name", FAMILIES)
def test_reset_matches_jax(name):
    keys = _keys(1)
    with jax.threefry_partitionable(False):
        want_state, want_obs = _jit(name, "reset")(jnp.asarray(keys))
    state, obs = _env(name, False).reset(_tkeys(keys))
    _match_tree(want_state, state, name)
    _match(want_obs, obs, f"{name} obs")


@pytest.mark.parametrize("name", FAMILIES)
def test_step_matches_jax(name):
    jstate, tstate, act = _state_pair(name, 2)
    keys = _keys(3)
    with jax.threefry_partitionable(False):
        want = _jit(name, "step")(jstate, jnp.asarray(act), jnp.asarray(keys))
    got = _env(name, False).step(tstate, torch.from_numpy(act), _tkeys(keys))
    _match_tree(want.state, got.state, name)
    for what in ("obs", "reward", "done"):
        _match(getattr(want, what), getattr(got, what), f"{name} {what}")
    assert got.done.any() and not got.done.all(), "the states must end some "\
        "episodes and not all"
    if name == "Snake":
        assert (got.reward == 1).any(), "a snake must eat"
        assert (got.state.length == 36).any(), "a snake must fill the board"
    if name == "CliffWalk":
        assert (got.reward == -100).any(), "an agent must fall"


@pytest.mark.parametrize("name", FAMILIES)
def test_scene_and_render_match_jax(name):
    jstate, tstate, _ = _state_pair(name, 4, n=4)
    env = _env(name, False)
    frames = env.render(tstate)
    assert frames.shape == (4, 84, 84) and frames.dtype == torch.float32
    _match(jax.jit(jax.vmap(_env(name, True).render))(jstate), frames,
           f"{name} frames", FRAME_ATOL)
    if name != "LightsOut":     # the JAX LightsOut builds its scene in render
        want_segs, want_int = _jit(name, "scene")(jstate)
        segs, intens = env.scene(tstate)
        _match(want_segs, segs, f"{name} segs")
        _match(want_int, intens, f"{name} intens")


def test_carve_path_per_lane():
    """Maze's path: a goal per lane, over (K, B) keys as `fresh_rows` gives."""
    keys = _keys(5, 2 * 24).reshape(2, 24, 2)
    goals = np.random.default_rng(6).integers(0, 64, (2, 24))
    with jax.threefry_partitionable(False):
        want = jax.jit(jax.vmap(jax.vmap(
            lambda k, g: jax_carve_path(k, 8, 8, g // 8, g % 8))))(
                jnp.asarray(keys), jnp.asarray(goals))
    got = carve_path(_tkeys(keys), 8, 8, torch.from_numpy(goals // 8),
                     torch.from_numpy(goals % 8))
    _match(want, got, "carve_path")
    assert (got.sum(-1) == torch.from_numpy(goals // 8 + goals % 8 + 1)).all()


def test_place_food_matches_jax():
    """Random priorities and bodies, a long food chain (k up to 10**4) and
    full boards, where every cell is taken and the tie goes to cell 0."""
    rng = np.random.default_rng(7)
    prio = rng.random((B, 36)).astype(np.float32)
    ages = (rng.random((B, 36)) < 0.5) * rng.integers(1, 36, (B, 36))
    ages[:4] = 1
    head = rng.integers(0, 36, B)
    k = rng.integers(0, 10_000, B)
    args = [x.astype(np.int32) if x.dtype.kind == "i" else x
            for x in (prio, ages, head, k)]
    want = jax.jit(jax.vmap(jax_place_food))(*map(jnp.asarray, args))
    got = place_food(*map(torch.from_numpy, args))
    _match(want, got, "place_food")


def test_lightsout_solver_matches_jax():
    rng = np.random.default_rng(8)
    for _ in range(4):
        board = (rng.random((5, 5)) < 0.5).astype(np.int32)
        try:
            want = JLightsOut().solve(board)
        except ValueError:
            with pytest.raises(ValueError, match="unsolvable"):
                LightsOut().solve(board)
            continue
        assert LightsOut().solve(board) == want


def test_multidiscrete_sample_batch_matches_jax():
    nvec = (4, 3, 7, 2, 5)
    keys = _keys(9, 3)
    with jax.threefry_partitionable(False):
        want = jax.vmap(lambda k: jax_sample_batch(JMultiDiscrete(nvec), k,
                                                   6))(jnp.asarray(keys))
    got = sample_batch(MultiDiscrete(nvec), _tkeys(keys), 6)
    _match(want, got, "MultiDiscrete sample_batch")


# -- pools -----------------------------------------------------------------------

def test_registry_matches_jax():
    """All 28 ids of the JAX registry, and no other."""
    assert repro_torch.registered() == sorted(jax_registered())
    assert len(repro_torch.registered()) == 28


@pytest.mark.parametrize("name", NEW_IDS)
def test_supports_matches_jax(name):
    assert supports_fused_step(make(name)) == jax_supports(jax_make(name))


@pytest.mark.parametrize("name", ("Maze-v0", "Snake-raw"))
def test_fused_step_gives_cell_codes(name):
    """The fused step's observations come back as int32 cell codes, equal to
    JAX's jnp fused step from the same states."""
    b, k = 5, 6
    base = name.split("-")[0]
    jstate, tstate, _ = _state_pair(base, 10, n=b)
    acts = np.random.default_rng(11).integers(0, 4, (k, b)).astype(np.int32)
    with jax.threefry_partitionable(False):
        jenv = jax_make(name)
        js, _ = jax.jit(JVec(JAutoReset(jenv), b).reset)(jax.random.PRNGKey(12))
        js = js._replace(inner=js.inner._replace(inner=jstate)
                         if name.endswith("-v0") else jstate)
        jnew, jts = jax.jit(lambda s, a: jax_fused_step(
            jenv, s, a, backend="jnp"))(js, jnp.asarray(acts))
    env = make(name)
    ts_state, _ = Vec(AutoReset(env), b).reset(R.PRNGKey(12, "cpu"))
    ts_state = _load_like(ts_state, js, "cpu")
    new, ts = fused_step(env, ts_state, torch.from_numpy(acts),
                         backend="torch")
    assert ts.obs.dtype == torch.int32 == ts.info["terminal_obs"].dtype
    # the fresh rows go to the CUDA kernel, which takes float32 only
    _, fresh, fobs = fresh_rows(env, ts_state.key, k)
    assert fresh.dtype == fobs.dtype == torch.float32
    _match_tree(jnew, new, f"{name} state")
    _match_tree(jts, ts, f"{name} timestep")
    assert ts.done.any()


#: golden rows the `auto` case of a -px id replays (see below)
PX_AUTO_ROWS = 3


@pytest.mark.parametrize("backend", ("vmap", "auto"))
@pytest.mark.parametrize("name", NEW_IDS)
def test_goldens_through_make_vec(name, backend):
    """tests/test_envspec.py::_pool_trace, through the port.

    For a -px id `auto` resolves to the very vmap pool of the `vmap` case,
    which replays the whole trace; its `auto` case checks what only it can
    show: the resolution, the reset and the first PX_AUTO_ROWS rows.
    """
    want = json.loads((GOLDEN_DIR / f"{name}.json").read_text())
    batch = want["batch"]
    pool = repro_torch.make_vec(name, batch, backend=backend, device="cpu")
    fused = backend == "auto" and name.split("-")[0] in FUSED and (
        not name.endswith("-px"))
    assert pool.backend == ("torch" if fused else "vmap")
    steps = want["steps"]
    if backend == "auto" and name.endswith("-px"):
        steps = PX_AUTO_ROWS
    handle = pool.xla()
    key = R.PRNGKey(sum(map(ord, name)), "cpu")
    ps = handle.init(key)
    assert list(ps.obs.shape[1:]) == want["obs_shape"]
    assert str(ps.obs.dtype).split(".")[-1] == want["obs_dtype"]
    np.testing.assert_allclose(float(ps.obs.double().sum()),
                               want["reset_obs_sum"], rtol=1e-4, atol=1e-4)
    rows = []
    for t in range(steps):
        a = sample_batch(pool.action_space, R.fold_in(key, 1000 + t), batch)
        ps, out = handle.step(ps, a, R.fold_in(key, t))
        rows.append([float(out.obs.double().sum()),
                     float(out.reward.double().sum()), int(out.done.sum())])
    np.testing.assert_allclose(np.asarray(rows),
                               np.asarray(want["rows"][:steps]),
                               rtol=1e-4, atol=1e-4,
                               err_msg=f"{name} ({backend}) left its golden")


@pytest.mark.parametrize("name", ("Multitask-v0", "Multitask-raw"))
def test_multitask_rollout_matches_jax(name):
    """Multitask draws its new ball and obstacle from the per-step lane
    keys: the rollout gives step i the key `fold_in(key, i)`, which `Vec`
    splits per lane, as in the JAX pool."""
    b, steps = 16, 60
    with jax.threefry_partitionable(False):
        j_rew, j_eps, _ = jax_make_vec(name, b).rollout(
            steps, jax.random.PRNGKey(13))
    pool = repro_torch.make_vec(name, b, device="cpu")
    assert pool.backend == "vmap"
    rew, eps, _ = pool.rollout(steps, R.PRNGKey(13, "cpu"))
    _match(j_eps, eps, f"{name} episodes")
    _match(j_rew, rew, f"{name} sum_reward")
    assert int(eps.sum()) > 0, "episodes must end, so new balls are drawn"


def test_multitask_stateful_step_matches_jax():
    """The stateful step, with the carry's key chain (no key) and with an
    explicit key, then `step_many` with its `fold_in(key, i)` keys."""
    b, name = 8, "Multitask-v0"
    pool = repro_torch.make_vec(name, b, device="cpu")
    with jax.threefry_partitionable(False):
        jpool = jax_make_vec(name, b)
        _match(jpool.reset(seed=14), pool.reset(seed=14), "reset obs")
        for t in range(40):
            ja, a = jpool.sample_actions(seed=t), pool.sample_actions(seed=t)
            if t % 2:
                want = jpool.step(ja, jax.random.PRNGKey(100 + t))
                got = pool.step(a, R.PRNGKey(100 + t, "cpu"))
            else:
                want, got = jpool.step(ja), pool.step(a)
            for i, what in enumerate(("obs", "reward", "done")):
                _match(want[i], got[i], f"{what} {t}")
            _match_tree(want[3], got[3], f"info {t}")
        _match_tree(jpool.state_dict(), pool.state_dict(), "snapshot")
        jh, h = jpool.xla(), pool.xla()
        jps, ps = jh.init(jax.random.PRNGKey(15)), h.init(R.PRNGKey(15, "cpu"))
        acts = np.random.default_rng(16).integers(0, 3, (30, b)).astype(np.int32)
        jps, jout = jax.jit(jh.step_many)(jps, jnp.asarray(acts),
                                          jax.random.PRNGKey(17))
    ps, out = h.step_many(ps, torch.from_numpy(acts), R.PRNGKey(17, "cpu"))
    _match_tree(jout, out, "step_many")
    _match_tree(jps, ps, "step_many carry")
    assert out.done.any()
