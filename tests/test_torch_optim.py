"""The port's optimizers, schedules and losses (`repro_torch.train.optim`)
against the JAX package's `repro.train.optim`, on the same inputs made by
numpy from a seed.

Floats are held to the parity contract's 1e-5/1e-6
(`conftest.assert_leaves_match`), step counters exactly. Adam's first step
turns a gradient into about ±lr whatever its size, so a component that is
pure rounding noise could flip sign between the packages; the gradients
here are numpy draws, the same bits on both sides, so none is noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from conftest import assert_leaves_match
from repro.train import optim as J
from repro_torch.train import optim as T


def _tree(rng):
    """A param-shaped tree: a list of dense layers and a dict of convs."""
    return {"dense": [{"w": rng.standard_normal((5, 3)).astype(np.float32),
                       "b": rng.standard_normal(3).astype(np.float32)}
                      for _ in range(2)],
            "conv": {"w": rng.standard_normal((2, 2, 1, 4)).astype(np.float32),
                     "b": np.zeros(4, np.float32)}}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return tree_map(torch.from_numpy, tree)


def _match(want, got, what):
    """Leaf by leaf; jax.tree.leaves orders both trees' dict keys alike."""
    assert_leaves_match(jax.tree.map(np.asarray, want),
                        tree_map(lambda x: x.numpy(), got), what)


OPTIMIZERS = {
    "adam": dict(lr=3e-4),
    "adam_clip": dict(lr=1e-3, clip_norm=0.5),
    "adamw": dict(lr=1e-3, weight_decay=0.01),
    "adamw_clip_cosine": dict(weight_decay=0.1, clip_norm=1.0),
}


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_adam_updates(name):
    """Five updates from one tree with fresh gradients each, the state
    threaded through each package's own updates."""
    kw = dict(OPTIMIZERS[name])
    if name.endswith("cosine"):
        jkw = dict(kw, lr=J.cosine_schedule(1e-3, 2, 10))
        tkw = dict(kw, lr=T.cosine_schedule(1e-3, 2, 10))
    else:
        jkw = tkw = kw
    rng = np.random.default_rng(3)
    params = _tree(rng)
    jopt, topt = J.Adam(**jkw), T.Adam(**tkw)
    jp, tp = _jax(params), _torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(5):
        grads = jax.tree.map(lambda x: (3.0 * x).astype(np.float32),
                             _tree(rng))
        jp, js = jopt.update(_jax(grads), js, jp)
        tp, ts = topt.update(_torch(grads), ts, tp)
        _match(jp, tp, f"{name} params, update {i}")
        _match(js.mu, ts.mu, f"{name} mu, update {i}")
        _match(js.nu, ts.nu, f"{name} nu, update {i}")
        assert int(ts.step) == int(js.step) == i + 1
        assert ts.step.dtype == torch.int32


@pytest.mark.parametrize("momentum", (0.0, 0.9))
def test_sgd_updates(momentum):
    rng = np.random.default_rng(4)
    params = _tree(rng)
    jopt, topt = J.SGD(lr=0.05, momentum=momentum), T.SGD(lr=0.05,
                                                         momentum=momentum)
    jp, tp = _jax(params), _torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        grads = _tree(rng)
        jp, js = jopt.update(_jax(grads), js, jp)
        tp, ts = topt.update(_torch(grads), ts, tp)
        _match(jp, tp, f"sgd({momentum}) params, update {i}")
    assert (ts.mu is None) == (momentum == 0.0)


@pytest.mark.parametrize("max_norm", (0.1, 1e3))
def test_global_norm_and_clip(max_norm):
    tree = _tree(np.random.default_rng(5))
    np.testing.assert_allclose(T.global_norm(_torch(tree)).numpy(),
                               np.asarray(J.global_norm(_jax(tree))),
                               rtol=1e-6)
    _match(J.clip_by_global_norm(_jax(tree), max_norm),
           T.clip_by_global_norm(_torch(tree), max_norm), "clip")


def test_schedules():
    steps = np.arange(0, 130, dtype=np.int32)
    for jfn, tfn in ((J.linear_schedule(1.0, 0.01, 48),
                      T.linear_schedule(1.0, 0.01, 48)),
                     (J.linear_schedule(0.5, 0.5, 0),
                      T.linear_schedule(0.5, 0.5, 0)),
                     (J.cosine_schedule(3e-4, 10, 100, floor=1e-5),
                      T.cosine_schedule(3e-4, 10, 100, floor=1e-5))):
        want = np.asarray(jfn(jnp.asarray(steps)))
        got = tfn(torch.from_numpy(steps))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_losses():
    rng = np.random.default_rng(6)
    pred = (3 * rng.standard_normal(64)).astype(np.float32)
    target = (3 * rng.standard_normal(64)).astype(np.float32)
    for delta in (1.0, 0.5):
        np.testing.assert_allclose(
            T.huber_loss(torch.from_numpy(pred), torch.from_numpy(target),
                         delta).numpy(),
            np.asarray(J.huber_loss(pred, target, delta)), rtol=1e-6,
            atol=1e-7)
    logits = rng.standard_normal((4, 3, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (4, 3)).astype(np.int32)
    np.testing.assert_allclose(
        T.softmax_cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels)).numpy(),
        np.asarray(J.softmax_cross_entropy(logits, labels)), rtol=1e-6,
        atol=1e-6)
