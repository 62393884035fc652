"""The port's plain megastep (`repro_torch.kernels.envstep.megastep_ref`)
against the JAX package's jnp reference and its Pallas kernel in interpret
mode, for the four classic bodies, the two arcade ones (Pong, Breakout) and
the five grid and puzzle ones (LightsOut, FrozenLake, CliffWalk, Maze,
Snake) with and without a TimeLimit, at B = 200 (not a multiple of the
128-lane block) and K = 8. The grid states are those of
tests/test_torch_grid.py::grid_rows: agents beside holes, cliffs and goals,
snakes beside food, walls and their own body, boards a move from a win.

The CUDA kernel itself is held against this plain version (after
`fresh_rows`, which makes the resets the kernel makes in-kernel) on the
card by chip_smoke.py. Here: the dispatch, and that a CPU tensor never
reaches it.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.envs.arcade as JA
import repro.envs.classic as JC
import repro.envs.grid as JG
import repro_torch.envs.arcade as TA
import repro_torch.envs.classic as TC
import repro_torch.envs.grid as TG
from repro.envs.puzzle import LightsOut as JLightsOut
from repro.kernels.envstep import megastep_pallas
from repro.kernels.envstep import megastep_ref as jax_megastep_ref
from repro.kernels.envstep import spec_for as jax_spec_for
from repro_torch import random as R
from repro_torch.core.wrappers import TimeLimit
from repro_torch.envs.puzzle import LightsOut as TLightsOut
from repro_torch.kernels.envstep import (env_megastep, fresh_rows,
                                         megastep_cuda, megastep_ref, spec_for)
from test_torch_grid import grid_rows


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B, K = 200, 8
MAX_STEPS = {"CartPole": 500, "MountainCar": 200, "Pendulum": 200,
             "Acrobot": 500, "Pong": 1000, "Breakout": 1000, "LightsOut": 100,
             "FrozenLake": 100, "CliffWalk": 100, "Maze": 200, "Snake": 200}
STATE_RANGES = {
    "CartPole": [(-2.4, 2.4), (-2.0, 2.0), (-0.21, 0.21), (-2.0, 2.0)],
    "MountainCar": [(-1.2, 0.6), (-0.07, 0.07)],
    "Pendulum": [(-3 * math.pi, 3 * math.pi), (-8.0, 8.0)],
    "Acrobot": [(-math.pi, math.pi), (-math.pi, math.pi),
                (-4.0, 4.0), (-4.0, 4.0)],
}
#: float atol per body. Acrobot's is looser, for this reason: XLA's CPU
#: backend fuses some of the RK4's multiply-adds into FMAs and the port
#: rounds every op apart; the chaotic double pendulum roughly doubles that
#: one-ulp gap each step, to a few 1e-5 after K = 8 steps (done and
#: truncated stay exact). Velocities stay moderate for the same reason;
#: one step at full speed, clamps included, is held at 1e-6 in
#: tests/test_torch_envs.py.
ATOL = {name: 1e-4 if name == "Acrobot" else 1e-6 for name in MAX_STEPS}
GRID = ("LightsOut", "FrozenLake", "CliffWalk", "Maze", "Snake")
CASES = [(name, tl) for name in MAX_STEPS for tl in (True, False)]


def _env(name, jax_side):
    if name == "LightsOut":
        return JLightsOut() if jax_side else TLightsOut()
    if name in GRID:
        return getattr(JG if jax_side else TG, name)()
    arcade = name in ("Pong", "Breakout")
    mod = (JA if arcade else JC) if jax_side else (TA if arcade else TC)
    return getattr(mod, name)()


def _arcade_rows(name, rng, lead):
    """Arcade state rows: balls that reach the paddles and edges inside K
    steps; Breakout's in and around the brick region over random 0/1
    boards, a few nearly cleared, so bricks break and boards clear."""
    u = lambda lo, hi: rng.uniform(lo, hi, lead + (B,))
    sign = lambda: np.where(rng.random(lead + (B,)) < 0.5, -1.0, 1.0)
    if name == "Pong":
        return [u(0.0, 1.0), u(0.0, 1.0), sign() * 0.035, u(-0.05, 0.05),
                u(0.12, 0.88), u(0.12, 0.88)]
    board = rng.random(lead + (24, B)) < 0.5
    board &= rng.random(lead + (1, B)) < 0.8   # a fifth of the boards empty
    board[..., 9, :] = True                   # ... but for one brick
    return [u(0.0, 1.0), u(0.05, 0.5), u(-0.04, 0.04), sign() * u(0.02, 0.04),
            u(0.14, 0.86), *np.moveaxis(board, -2, 0)]


def _inputs(name, time_limit, seed=0):
    """numpy-seeded (state, actions, fresh, fresh_obs) rows, float32."""
    rng = np.random.default_rng(seed)
    o = jax_spec_for(_env(name, True)).obs_size
    grid = grid_rows(name, rng, B) if name in GRID else None

    def states(lead):
        if name in GRID:    # the first state is `grid`, with its steered act
            draws = [grid[0]] if not lead else [
                grid_rows(name, rng, B)[0] for _ in range(math.prod(lead))]
            rows = list(np.moveaxis(
                np.stack(draws).reshape(lead + (-1, B)), -2, 0))
        elif name in STATE_RANGES:
            rows = [rng.uniform(lo, hi, lead + (B,))
                    for lo, hi in STATE_RANGES[name]]
        else:
            rows = _arcade_rows(name, rng, lead)
        if time_limit:  # counters close enough to the limit to cut inside K
            rows.append(rng.integers(MAX_STEPS[name] - 2 * K, MAX_STEPS[name],
                                     lead + (B,)))
        return np.stack(rows, -2)

    if name == "Pendulum":
        act = rng.uniform(-3.0, 3.0, (K, B))
    elif name in GRID:
        act = rng.integers(0, 25 if name == "LightsOut" else 4, (K, B))
        act[0] = grid[1]       # the first step steers toward trouble
    else:
        act = rng.integers(0, 2 if name == "CartPole" else 3, (K, B))
    fresh = states((K,))
    if time_limit:
        fresh[:, -1] = 0
    return [x.astype(np.float32) for x in
            (states(()), act, fresh, rng.standard_normal((K, o, B)))]


def _check(want, got, what, atol=1e-6):
    names = ("new_state", "obs", "terminal_obs", "reward", "done", "truncated")
    for n, w, g in zip(names, want, got):
        w, g = np.asarray(w), g.numpy()
        assert w.shape == g.shape and g.dtype == np.float32, (what, n)
        if n in ("done", "truncated"):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {n}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol,
                                       err_msg=f"{what} {n}")


def _run_port(name, time_limit, ops):
    spec = spec_for(_env(name, False))
    return megastep_ref(spec.step_rows, *map(torch.from_numpy, ops),
                        max_steps=MAX_STEPS[name] if time_limit else None)


@pytest.mark.parametrize("name,time_limit", CASES)
def test_megastep_ref_matches_jax_ref(name, time_limit):
    ops = _inputs(name, time_limit)
    got = _run_port(name, time_limit, ops)
    want = jax_megastep_ref(jax_spec_for(_env(name, True)).step_rows,
                            *map(jnp.asarray, ops),
                            max_steps=MAX_STEPS[name] if time_limit else None)
    _check(want, got, f"{name} tl={time_limit} vs jnp ref", ATOL[name])
    assert got[4].sum() > 0 or name == "Pendulum" and not time_limit
    if time_limit:
        assert got[5].sum() > 0, "the inputs must exercise truncation"
    if name == "Breakout":
        assert (got[3] >= 1).any() and (got[3] >= 5).any(), (
            "bricks must break and a board must clear")
    if name == "Snake":
        assert (got[3] == 1).any(), "a snake must eat, so food is placed"


@pytest.mark.parametrize("name,time_limit", CASES)
def test_megastep_ref_matches_pallas_interpret(name, time_limit):
    ops = _inputs(name, time_limit, seed=1)
    got = _run_port(name, time_limit, ops)
    want = megastep_pallas(jax_spec_for(_env(name, True)).step_rows,
                           *map(jnp.asarray, ops),
                           max_steps=MAX_STEPS[name] if time_limit else None,
                           interpret=True)
    _check(want, got, f"{name} tl={time_limit} vs pallas interpret",
           ATOL[name])


def test_dispatch_on_cpu_tensors():
    """"auto" takes the plain version for CPU tensors (the auto-reset key
    chain and fresh rows of `fresh_rows`, then `megastep_ref`); "cuda"
    raises."""
    core = TimeLimit(TC.CartPole(), 500)
    spec = spec_for(core.env)
    state, act = (torch.from_numpy(x) for x in _inputs("CartPole", True)[:2])
    keys = R.split(R.PRNGKey(5, "cpu"), B)
    final_keys, fresh, fresh_obs = fresh_rows(core, keys, K)
    want = (megastep_ref(spec.step_rows, state, act, fresh, fresh_obs,
                         max_steps=500))
    want = (want[0], final_keys, *want[1:])
    got = env_megastep(spec, state, keys, act, core=core, max_steps=500,
                       backend="auto")
    assert len(got) == len(want) == 7
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    with pytest.raises(ValueError, match="CUDA tensors"):
        env_megastep(spec, state, keys, act, core=core, max_steps=500,
                     backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        megastep_cuda(spec.kernel_id, state, keys, act, max_steps=500)
    with pytest.raises(ValueError, match="unknown backend"):
        env_megastep(spec, state, keys, act, core=core, max_steps=500,
                     backend="pallas")
