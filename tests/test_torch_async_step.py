"""The async pool's two step views against the JAX package, on the CPU:
the lock-step facade (every lane active) and the masked step (some lanes).

  - the facade (`reset(seed)` / `step(actions)`) against the port's
    `EnvPool(backend="vmap")` and JAX's facade, step for step: CartPole-v1,
    and Multitask-v0, whose dynamics read the per-step keys;
  - `fused_step(active=)` on "torch" against JAX's `fused_step(active=)`
    from the same state, the mask changing between steps;
  - inactive lanes keep their state and auto-reset key bit for bit (the
    megastep returns every lane's key advanced) and report zeros, and
    active lanes get the unmasked step, on CartPole-v1, Maze-v0 and the
    frame-stacked Pong-v0.

tests/test_torch_async_pool.py drives the masked step through the pool's
send/recv against JAX's pool. The JAX side runs inside
`jax.threefry_partitionable(False)`. Ints, bools and keys exact; floats to
1e-5/1e-6.
"""
import jax
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

import repro_torch
from repro.core import make as jax_make
from repro.core.wrappers import AutoReset as JAutoReset
from repro.core.wrappers import Vec as JVec
from repro.pool import make_vec as jax_make_vec
from repro_torch import random as R
from repro_torch.core.spaces import sample_batch
from repro_torch.core.wrappers import AutoReset, Vec
from repro_torch.pool import make_vec

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _legacy_threefry():
    with jax.threefry_partitionable(False):
        yield


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _match(want, got, what):
    want, got = _np(want), _np(got)
    assert want.shape == got.shape and want.dtype == got.dtype, (
        what, want.shape, got.shape, want.dtype, got.dtype)
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("name", ["CartPole-v1", "Multitask-v0"])
def test_facade_matches_both_vmap_pools(name):
    """With every slot active the async pool is the lock-step pool: the
    port's `EnvPool(backend="vmap")` and JAX's async facade, step for step
    (Multitask's dynamics read the per-step keys)."""
    n, steps = 4, 8
    apool = make_vec(name, n, backend="async", device=CPU)
    vpool = make_vec(name, n, backend="vmap", device=CPU)
    jpool = jax_make_vec(name, n, backend="async")
    want = vpool.reset(seed=123)
    _match(want, apool.reset(seed=123), f"{name} reset")
    _match(jpool.reset(seed=123), want, f"{name} reset vs jax")
    for t in range(steps):
        a = vpool.sample_actions(seed=t)
        ref, got, jref = vpool.step(a), apool.step(a), jpool.step(a.numpy())
        for i, what in enumerate(("obs", "reward", "done")):
            _match(ref[i], got[i], f"{name} {what} {t}")
            _match(jref[i], got[i], f"{name} {what} {t} vs jax")
        for k in ref[3]:
            _match(ref[3][k], got[3][k], f"{name} info[{k}] {t}")
            _match(jref[3][k], got[3][k], f"{name} info[{k}] {t} vs jax")


MASKS = ([1, 0, 1, 1, 0, 1], [0, 1, 1, 0, 0, 1], [1, 1, 0, 1, 0, 0])


def _carried_states(name, b=6):
    env = repro_torch.make(name)
    state, _ = Vec(AutoReset(env), b).reset(R.PRNGKey(7, CPU))
    return env, state


def test_masked_step_matches_jax():
    """`fused_step(active=)` on "torch" against JAX's `fused_step(active=)`
    from the same state, three steps, the mask changing (so a lane idles
    after it stepped): outputs and new state, keys exact."""
    name, b = "CartPole-v1", 6
    env, state = _carried_states(name, b)
    jenv = jax_make(name)
    jstate, _ = JVec(JAutoReset(jenv), b).reset(jax.random.PRNGKey(7))
    jstep = jax.jit(lambda s, a, m: jenv.fused_step(
        s, a, num_steps=1, backend="jnp", active=m))
    for t, m in enumerate(MASKS):
        acts = sample_batch(env.action_space, R.fold_in(R.PRNGKey(7, CPU),
                                                        100 + t), b)
        state, ts = env.fused_step(state, acts[None], num_steps=1,
                                   backend="torch",
                                   active=torch.tensor(m, dtype=torch.bool))
        jstate, jts = jstep(jstate, np.asarray(acts)[None],
                            np.asarray(m, bool))
        for field in ("obs", "reward", "done"):
            _match(getattr(jts, field), getattr(ts, field), f"{field} {t}")
        for k in ts.info:
            _match(jts.info[k], ts.info[k], f"info[{k}] {t}")
        _match(jstate.key, state.key.numpy().astype(np.uint32), f"keys {t}")
        for f in ("x", "x_dot", "theta", "theta_dot"):
            _match(getattr(jstate.inner.inner, f),
                   getattr(state.inner.inner, f), f"state.{f} {t}")


@pytest.mark.parametrize("name", ["CartPole-v1", "Maze-v0", "Pong-v0"])
def test_masked_step_keeps_inactive_lanes(name):
    """Inactive lanes keep their state and auto-reset key bit for bit (the
    kernel returned them advanced) and report zero obs, reward, done and
    info; active lanes get what the unmasked step gives them. Pong-v0's
    lanes carry a frame stack."""
    env, state = _carried_states(name)
    for t, m in enumerate(MASKS):
        active = torch.tensor(m, dtype=torch.bool)
        acts = sample_batch(env.action_space, R.fold_in(R.PRNGKey(7, CPU),
                                                        100 + t), len(m))
        new, ts = env.fused_step(state, acts[None], num_steps=1,
                                 backend="torch", active=active)
        full, fts = env.fused_step(state, acts[None], num_steps=1,
                                   backend="torch")
        idle = ~active
        assert not torch.equal(state.key[idle], full.key[idle])
        for old, sel, unmasked in zip(tree_leaves(state), tree_leaves(new),
                                      tree_leaves(full), strict=True):
            assert torch.equal(old[idle], sel[idle]), (name, t)
            assert torch.equal(unmasked[active], sel[active]), (name, t)
        for x, y in ((ts.obs, fts.obs), (ts.reward, fts.reward),
                     (ts.done, fts.done),
                     *((ts.info[k], fts.info[k]) for k in ts.info)):
            assert not x[:, idle].any(), (name, t)
            assert torch.equal(x[:, active], y[:, active]), (name, t)
        state = new
