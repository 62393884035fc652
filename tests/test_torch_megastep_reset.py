"""The megastep's in-kernel auto-reset, rehearsed on the CPU.

The CUDA megastep (src/repro_torch/csrc/megastep.cu) carries each lane's
auto-reset key chain and runs every env's reset inside the kernel, from
threefry blocks it computes one at a time. It cannot run here, so this file
holds the layout facts its reset bodies are written against, block by
block through the port's own `random.threefry2x32`, bit for bit against
`random.py`: `random_bits` cut in halves (block j gives elements j and
j + h), `split` into 2 and 3 keys, `uniform`'s op order, `randint`'s
wrapping combination, and Maze's walls as two 32-bit words from blocks
0..31 with the kernel's carved path and goal. chip_smoke.py holds the
kernel against `fresh_rows` + `megastep_ref` on the card.

Then the fused step of the plain version (the kernel's twin) under a
TimeLimit of 3, so every lane resets twice or more in K = 8 steps, against
the JAX package's fused step: ints, bools and keys exact, floats at
1e-5/1e-6, frames at 1e-5 (tests/test_torch_arcade.py says why). The JAX
side runs the legacy threefry layout (`jax.threefry_partitionable(False)`).

Last, the geometry the kernel compiles in: an instance whose grid sizes or
scramble presses differ from its body's never reaches the kernel.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.pipeline as JP
import repro.envs.arcade as JA
import repro.envs.classic as JC
import repro.envs.grid as JG
import repro_torch
import repro_torch.core.pipeline as P
import repro_torch.envs.arcade as TA
import repro_torch.envs.classic as TC
import repro_torch.envs.grid as TG
from repro.core.wrappers import AutoReset as JAutoReset
from repro.core.wrappers import Vec as JVec
from repro.kernels.envstep import fused_step as jax_fused_step
from repro_torch import random as R
from repro_torch.core.registry import make
from repro_torch.core.wrappers import AutoReset, Vec
from repro_torch.envs.grid.common import carve_path
from repro_torch.envs.puzzle import LightsOut
from repro_torch.kernels.envstep import (BODIES, env_megastep, fused_step,
                                         spec_for)
from repro_torch.kernels.envstep.ops import state_rows
from repro_torch.pool import EnvPool, auto_backend
from repro_torch.pool.envpool import _load_like
from test_torch_grid import _match_tree


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


KEYS = R.split(R.PRNGKey(3, "cpu"), 16)          # (16, 2)
U32 = np.uint32


def _block(keys, x0, x1):
    """The kernel's `threefry2x32(key, x0, x1)` for every key: (y0, y1)."""
    k1, k2 = keys[..., 0], keys[..., 1]
    return R.threefry2x32(k1, k2, torch.full_like(k1, x0),
                          torch.full_like(k1, x1))


def _uniform(bits, lo=0.0, hi=1.0):
    """The kernel's `uniform` in numpy float32, each op rounded apart."""
    f = ((np.asarray(bits).astype(U32) >> U32(9)) | U32(0x3F800000)).view(
        np.float32)
    lo32, hi32 = np.float32(lo), np.float32(hi)
    v = (f - np.float32(1.0)) * (hi32 - lo32) + lo32
    return np.maximum(v, lo32)


def _randint_of(higher, lower, lo, hi):
    """The kernel's `randint_of<lo, hi>` in wrapping uint32 arithmetic."""
    span = U32(hi - lo)
    mult = U32((65536 % int(span)) ** 2 % int(span))
    higher, lower = (np.asarray(x).astype(U32) for x in (higher, lower))
    with np.errstate(over="ignore"):
        offset = (higher % span) * mult + lower % span
    return (offset % span).astype(np.int64) + lo


@pytest.mark.parametrize("n", (1, 4, 6, 7, 14, 16, 36, 48, 64))
def test_random_bits_and_uniform_by_halves(n):
    h = (n + 1) // 2
    bits = torch.empty(KEYS.shape[:-1] + (n,), dtype=torch.int64)
    for j in range(h):
        y0, y1 = _block(KEYS, j, j + h if j + h < n else 0)
        bits[:, j] = y0
        if j + h < n:
            bits[:, j + h] = y1
    assert torch.equal(bits, R.random_bits(KEYS, (n,)))
    for lo, hi in ((0.0, 1.0), (-0.05, 0.05), (-math.pi, math.pi),
                   (0.3, 0.7), (-0.6, -0.4)):
        want = R.uniform(KEYS, (n,), lo, hi).numpy()
        got = _uniform(bits.numpy(), lo, hi)
        np.testing.assert_array_equal(got.view(U32), want.view(U32),
                                      err_msg=f"n={n} [{lo}, {hi})")


def test_scalar_draws_are_block_0_0():
    y0, _ = _block(KEYS, 0, 0)
    assert torch.equal(y0, R.random_bits(KEYS, ()))
    np.testing.assert_array_equal(
        _uniform(y0.numpy(), -0.02, 0.02).view(U32),
        R.uniform(KEYS, (), -0.02, 0.02).numpy().view(U32))
    assert np.array_equal(_uniform(y0.numpy()) < np.float32(0.5),
                          R.bernoulli(KEYS).numpy())


def test_split_in_two_and_three_by_blocks():
    (a0, a1), (b0, b1) = _block(KEYS, 0, 2), _block(KEYS, 1, 3)
    two = R.split(KEYS)
    assert torch.equal(two[:, 0], torch.stack([a0, b0], -1))   # next key
    assert torch.equal(two[:, 1], torch.stack([a1, b1], -1))   # reset key
    (a0, a1), (b0, b1), (c0, c1) = (_block(KEYS, j, j + 3) for j in range(3))
    three = R.split(KEYS, 3)
    for i, (x, y) in enumerate(((a0, b0), (c0, a1), (b1, c1))):
        assert torch.equal(three[:, i], torch.stack([x, y], -1)), i


@pytest.mark.parametrize("shape,lo,hi", (((6,), 0, 25), ((), 0, 3),
                                         ((), 32, 64), ((7,), 5, 9)))
def test_randint_from_two_split_draws(shape, lo, hi):
    first, second = R.split(KEYS).unbind(-2)
    higher = R.random_bits(first, shape).numpy()
    lower = R.random_bits(second, shape).numpy()
    np.testing.assert_array_equal(_randint_of(higher, lower, lo, hi),
                                  R.randint(KEYS, shape, lo, hi).numpy())


def _carve(keys, n_rows, n_cols, goal_r, goal_c):
    """The kernel's `carve_path`: the row picks as bits of one word, the
    path as bits of one integer (uint64 per lane)."""
    steps = n_rows + n_cols - 2
    row_pick = (_uniform(R.random_bits(keys, (steps,)).numpy()) < 0.5)
    r = np.zeros(len(keys), np.int64)
    c = np.zeros_like(r)
    path = np.ones(len(keys), np.uint64)
    for i in range(steps):
        need_r, need_c = goal_r - r, goal_c - c
        go_row = (need_r != 0) & ((need_c == 0) | row_pick[:, i])
        go_col = ~go_row & (need_c != 0)
        r = r + np.where(go_row, np.sign(need_r), 0)
        c = c + np.where(go_col, np.sign(need_c), 0)
        path |= np.left_shift(np.uint64(1), (r * n_cols + c).astype(np.uint64))
    return path


def _bits_of(plane):
    """(..., m) 0/1 tensor -> uint64 integers, bit i from cell i."""
    weights = np.left_shift(np.uint64(1), np.arange(plane.shape[-1],
                                                    dtype=np.uint64))
    return (plane.numpy().astype(np.uint64) * weights).sum(-1, dtype=np.uint64)


def test_maze_walls_as_two_words():
    """Maze's reset as the kernel computes it: split(key, 3); walls from
    blocks j = 0..31 of the first key, cell j from y0 into the low word and
    cell j + 32 from y1 into the high word (two ballots in the warp draw);
    the goal by randint; the carved path cleared."""
    state, _ = TG.Maze().reset(KEYS)
    k0, k1, k2 = R.split(KEYS, 3).unbind(-2)
    p = np.float32(0.35)                              # maze.py::WALL_P
    lo = np.zeros(len(KEYS), np.uint64)
    hi = np.zeros_like(lo)
    for j in range(32):
        y0, y1 = (x.numpy() for x in _block(k0, j, j + 32))
        lo |= (_uniform(y0) < p).astype(np.uint64) << np.uint64(j)
        hi |= (_uniform(y1) < p).astype(np.uint64) << np.uint64(j)
    first, second = R.split(k1).unbind(-2)
    goal = _randint_of(_block(first, 0, 0)[0].numpy(),
                       _block(second, 0, 0)[0].numpy(), 32, 64)
    np.testing.assert_array_equal(goal, state.goal.numpy())
    path = _carve(k2, 8, 8, goal // 8, goal % 8)
    np.testing.assert_array_equal(
        path, _bits_of(carve_path(k2, 8, 8, state.goal // 8, state.goal % 8)))
    np.testing.assert_array_equal((lo | hi << np.uint64(32)) & ~path,
                                  _bits_of(state.walls))
    assert (state.walls.sum(-1) > 0).all()


# -- the fused step under a short TimeLimit, against JAX -----------------------

FUSED_B, FUSED_K, LIMIT = 5, 8, 3
#: id -> (JAX core, port core, pixel pipeline)
FUSED_CASES = {
    "CartPole-v1": (JC.CartPole, TC.CartPole, False),
    "Maze-v0": (JG.Maze, TG.Maze, False),
    "Snake-v0": (JG.Snake, TG.Snake, False),
    "Pong-v0": (JA.Pong, TA.Pong, True),
}


def _stack(mod, core, pixels):
    steps = (mod.TimeLimit(LIMIT),)
    if pixels:
        steps += (mod.ObsToPixels(), mod.FrameStack(4))
    return mod.build_pipeline(core(), steps)


@pytest.mark.parametrize("env_id", FUSED_CASES)
def test_fused_step_resets_match_jax(env_id):
    jcore, tcore, pixels = FUSED_CASES[env_id]
    n_act = 2 if env_id.startswith("CartPole") else (3 if pixels else 4)
    acts = np.random.default_rng(4).integers(
        0, n_act, (FUSED_K, FUSED_B)).astype(np.int32)
    with jax.threefry_partitionable(False):
        jenv = _stack(JP, jcore, pixels)
        js, _ = jax.jit(JVec(JAutoReset(jenv), FUSED_B).reset)(
            jax.random.PRNGKey(21))
        jnew, jts = jax.jit(lambda s, a: jax_fused_step(
            jenv, s, a, backend="jnp"))(js, jnp.asarray(acts))
    env = _stack(P, tcore, pixels)
    state, _ = Vec(AutoReset(env), FUSED_B).reset(R.PRNGKey(21, "cpu"))
    _match_tree(js, state, f"{env_id} reset")
    state = _load_like(state, js, "cpu")
    new, ts = fused_step(env, state, torch.from_numpy(acts), backend="torch")
    _match_tree(jnew, new, f"{env_id} state")
    frames = " frames" if pixels else ""     # FRAME_ATOL for rendered obs
    _match_tree(jts.obs, ts.obs, f"{env_id} obs{frames}")
    _match_tree(jts.info["terminal_obs"], ts.info["terminal_obs"],
                f"{env_id} terminal_obs{frames}")
    for what in ("reward", "done"):
        _match_tree(getattr(jts, what), getattr(ts, what), f"{env_id} {what}")
    _match_tree(jts.info["truncated"], ts.info["truncated"],
                f"{env_id} truncated")
    # every lane is cut at steps 3 and 6 at the latest
    assert (ts.done.sum(0) >= 2).all()
    assert ts.info["truncated"].any()


# -- the geometry the kernel compiles in ---------------------------------------

REGISTRY_IDS = ("CartPole-v1", "MountainCar-v0", "Pendulum-v1", "Acrobot-v1",
                "Pong-v0", "Breakout-v0", "LightsOut-v0", "FrozenLake-v0",
                "CliffWalk-v0", "Maze-v0", "Snake-v0")
CUDA = torch.device("cuda")


@pytest.mark.parametrize("env_id", REGISTRY_IDS)
def test_registry_defaults_take_the_kernel(env_id):
    env = make(env_id)
    assert spec_for(env.unwrapped).kernel_mismatch is None
    assert auto_backend(env, CUDA) == "cuda"
    assert auto_backend(env, torch.device("cpu")) == "torch"


def _mismatched():
    return {"CliffWalk(3, 16)": (TG.CliffWalk(3, 16), "n_rows"),
            "CliffWalk(4, 10)": (TG.CliffWalk(4, 10), "n_cols"),
            "LightsOut(scramble_presses=4)": (LightsOut(scramble_presses=4),
                                              "scramble_presses"),
            "Maze(6)": (TG.Maze(6), "'n'")}


@pytest.mark.parametrize("what", _mismatched())
def test_other_geometry_never_reaches_the_kernel(what):
    core, named = _mismatched()[what]
    spec = spec_for(core)
    assert spec.kernel_mismatch is not None and named in spec.kernel_mismatch
    env = P.build_pipeline(core, (P.TimeLimit(50),))
    assert auto_backend(env, CUDA) == "vmap"
    with pytest.raises(NotImplementedError, match=named):
        EnvPool(env, 4, backend="cuda", device="cpu")
    state, _ = Vec(AutoReset(env), 4).reset(R.PRNGKey(0, "cpu"))
    rows = state_rows(spec, 50, state.inner).contiguous()
    with pytest.raises(NotImplementedError, match=named):
        env_megastep(spec, rows, state.key, torch.zeros(2, 4), core=env,
                     max_steps=50, backend="cuda")
    # the plain version still fuses the instance's own geometry
    fused = repro_torch.make_vec(env, 4, unroll=4, device="cpu")
    vmap = repro_torch.make_vec(env, 4, backend="vmap", device="cpu")
    assert fused.backend == "torch"
    key = R.PRNGKey(1, "cpu")
    for got, want in zip(fused.rollout(12, key)[:2], vmap.rollout(12, key)[:2]):
        assert torch.equal(got, want)


def test_bodies_name_what_they_compile_in():
    assert dict(BODIES["CliffWalk"].params) == {"n_rows": 4, "n_cols": 12}
    assert dict(BODIES["LightsOut"].params) == {"n": 5, "scramble_presses": 6}
    for name in ("FrozenLake", "Maze", "Snake"):
        assert set(dict(BODIES[name].params)) == {"n"}
