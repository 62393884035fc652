"""The port's fused trainer and fleets (`repro_torch.train.fused`), on the CPU.

On the card `fused_train_chunk` captures train steps into CUDA graphs
(chip_smoke.py holds the replays against the eager run there); on the CPU
the same steps run as a plain loop, which these tests hold:

  - `run_fused` invariant to `chunk` (7 against 64), bit for bit;
  - DQN fused against host-alternating, bit for bit, and both training
    goldens (tests/golden/train_*.json) answered through
    `train_compiled(fused=True)` and `ppo.train(fused=True)`;
  - a fleet of width 2 whose rows equal their solo runs bit for bit, with
    each row's learning rate reaching Adam; `fleet_grid` and `_as_fleet`;
  - the graph runner's buffer handling, which needs no card: leaves that
    share memory are split before they become buffers, and the write-back
    of a new carry into them skips leaves written in place and survives
    leaves that swap buffers;
  - a request for the card on a machine without CUDA raises before any
    step runs.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map

import repro_torch
from repro_torch import random as R
from repro_torch.rl import dqn as TD
from repro_torch.rl import ppo as TPPO
from repro_torch.rl.replay import replay_add_batch, replay_init
from repro_torch.train import fused as F

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
EXACT = ("final_key", "replay_ptr", "replay_size", "replay_done_sum")
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are tiny: PyTorch's intra-op threads only add
    overhead to them, so each test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _answers_to_golden(gid, env, state, apply_fn):
    want = json.loads((GOLDEN_DIR / f"train_{gid.replace('/', '_')}.json")
                      .read_text())
    got = TD.golden_checksums(env, state, apply_fn)
    for k in EXACT:
        if k in want:
            assert got[k] == want[k], (gid, k)
    assert got["final_key"] == want["final_key"]
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{gid}.{k}")


@pytest.mark.parametrize("gid, backend", (("dqn/CartPole-v1", "torch"),
                                          ("dqn/FrozenLake-v0", "vmap")))
def test_dqn_fused_answers_to_golden(gid, backend):
    """`train_compiled(fused=True)` on each of the CPU's pools (the plain
    megastep and vmap) answers to the committed golden."""
    _, env_id, cfg, steps = F.golden_train_setup(gid)
    env = repro_torch.make(env_id)
    state, apply_fn, metrics = TD.train_compiled(
        env, dataclasses.replace(cfg, env_backend=backend), steps,
        R.PRNGKey(sum(map(ord, gid))), chunk=7, fused=True, device=CPU)
    assert tuple(metrics["loss"].shape) == (steps,)
    _answers_to_golden(gid, env, state, apply_fn)


def test_dqn_fused_is_host_alternating_whatever_the_chunk():
    """Fused with chunk 7 and 64 and the host-alternating loop: the same
    state and metrics bit for bit (the golden config, 40 steps: the ring
    wraps, learning starts and the target re-syncs)."""
    _, env_id, cfg, _ = F.golden_train_setup("dqn/CartPole-v1")
    env = repro_torch.make(env_id)
    runs = [TD.train_compiled(env, cfg, 40, R.PRNGKey(3), chunk=chunk,
                              fused=fused, device=CPU)
            for fused, chunk in ((True, 7), (True, 64), (False, 0))]
    (s7, _, m7), (s64, _, m64), (host, _, mh) = runs
    assert _equal(s7, s64) and _equal(m7, m64), "chunk 7 vs 64"
    assert _equal(s7, host) and _equal(m7, mh), "fused vs host-alternating"
    assert int(host.replay.size) == 80 > cfg.learn_start


def test_ppo_fused_answers_to_golden():
    """`ppo.train(fused=True)` in chunks of 3 updates, on "vmap" (the
    golden's host-alternating run on "torch" is tests/test_torch_ppo.py's)."""
    gid = "ppo/CartPole-v1"
    _, env_id, cfg, steps = F.golden_train_setup(gid)
    env = repro_torch.make(env_id)
    state, metrics = TPPO.train(env, cfg, steps,
                                R.PRNGKey(sum(map(ord, gid))), fused=True,
                                chunk=3, device=CPU)
    assert tuple(metrics["loss"].shape) == (steps,)
    _answers_to_golden(gid, env, state,
                       lambda p, o: TPPO.ac_apply(p, o, cfg.activation)[0])


def test_run_fused_chunks_are_exact_and_invariant():
    """`run_fused` runs exactly `steps` steps whatever `chunk` is, on the
    CPU as the plain loop, and its metrics stack on the step axis."""
    calls = []

    def step(carry):
        calls.append(1)
        key, sub = R.split(carry["key"])
        x = carry["x"] + R.uniform(sub, (3,))
        return {"key": key, "x": x}, {"sum": x.sum(), "key0": key[0] * 1.0}

    carry = {"key": R.PRNGKey(4), "x": torch.zeros(3)}
    results = [F.run_fused(step, carry, 20, chunk) for chunk in (0, 7, 64, 1)]
    assert len(calls) == 80
    for state, metrics in results[1:]:
        assert _equal(state, results[0][0]) and _equal(metrics, results[0][1])
    assert tuple(results[0][1]["sum"].shape) == (20,)


def test_fleet_rows_equal_their_solo_runs():
    _, env_id, cfg, _ = F.golden_train_setup("dqn/CartPole-v1")
    env = repro_torch.make(env_id)
    grid = F.Fleet(torch.tensor([5, 9], dtype=torch.int32),
                   torch.tensor([3e-4, 1e-3], dtype=torch.float32))
    states, metrics = F.fleet(env, grid, 24, cfg=cfg, chunk=10, device=CPU)
    assert tuple(metrics["loss"].shape) == (2, 24)
    assert tuple(states.step.shape) == (2,)
    for f in range(grid.width):
        solo_cfg = dataclasses.replace(cfg, lr=float(grid.lr[f]))
        solo, _, solo_m = TD.train_compiled(
            env, solo_cfg, 24, R.PRNGKey(int(grid.seed[f])), device=CPU)
        row = tree_map(lambda x: x[f], states)
        assert _equal(solo, row), f"fleet row {f}"
        assert _equal(solo_m, {k: v[f] for k, v in metrics.items()})
    # the two rows learnt at their own rates
    assert not torch.equal(states.params[0]["w"][0], states.params[0]["w"][1])


def test_fleet_grid_and_specs():
    g = F.fleet_grid([0, 1], [1e-3, 3e-4])
    assert g.width == 4
    assert g.seed.tolist() == [0, 0, 1, 1] and g.seed.dtype == torch.int32
    np.testing.assert_allclose(g.lr.numpy(), [1e-3, 3e-4, 1e-3, 3e-4])
    with pytest.raises(TypeError, match="unknown fleet grid"):
        F._as_fleet({"seeds": [0], "learning_rates": [1e-3]}, 3e-4)
    fl = F._as_fleet([3, 4, 5], 2e-4)
    assert fl.width == 3 and fl.lr.dtype == torch.float32
    assert F._as_fleet({"lrs": [1e-3]}, 3e-4).seed.tolist() == [0]
    with pytest.raises(ValueError, match="fleet algo"):
        F.fleet("CartPole-v1", [0], 1, algo="a2c", device=CPU)
    with pytest.raises(KeyError, match="golden"):
        F.golden_train_setup("dqn/Pong-v0")


def test_donate_safe_splits_shared_memory():
    base = torch.arange(6.0)
    carry = {"a": base, "b": base, "c": base[2:4], "d": torch.ones(2)}
    safe = F._donate_safe(carry)
    ptrs = [F._storage(x) for x in tree_leaves(safe)]
    assert len(set(ptrs)) == 4 and safe["a"] is base
    assert all(torch.equal(safe[k], carry[k]) for k in carry)


def test_write_back_skips_in_place_leaves_and_survives_swaps():
    """The graph runner's last captured act, run on the CPU: the ring the
    step wrote in place is its own buffer (not copied), and new leaves that
    are other buffers (a swap) are cloned before any buffer is written."""
    ring = replay_init(4, (2,), device=CPU)
    runner = F._GraphRunner(step_fn=None)
    carry = (ring, torch.tensor([1.0]), torch.tensor([2.0]))
    # what `_adopt` does, less the CUDA graph pool it makes
    runner.buffers, runner.spec = tree_flatten(F._donate_safe(carry))
    ring_buffers = [x.data_ptr() for x in runner.buffers[:5]]
    rows = torch.ones(1, 2)
    new_ring = replay_add_batch(ring, rows, torch.ones(1, dtype=torch.int32),
                                torch.ones(1), rows, torch.zeros(1))
    a, b = runner.buffers[-2], runner.buffers[-1]
    new = tree_leaves((new_ring, b, a))
    runner._write_back(new)
    assert [x.data_ptr() for x in runner.buffers[:5]] == ring_buffers
    assert int(runner.buffers[5]) == 1 and float(ring.obs[0].sum()) == 2.0
    assert float(runner.buffers[-2]) == 2.0 and float(runner.buffers[-1]) == 1.0
    with pytest.raises(ValueError, match="changed"):
        runner._write_back(tree_leaves((new_ring, a, torch.zeros(2))))


def test_pack_and_unpack_metrics():
    steps = [{"loss": torch.tensor(float(i)), "v": torch.full((2,), i * 1.0)}
             for i in range(3)]
    rows, layout = F._pack(steps)
    assert tuple(rows.shape) == (3, 3)
    out = F._unpack(rows, layout)
    assert out["loss"].tolist() == [0.0, 1.0, 2.0]
    assert out["v"].tolist() == [[0.0, 0.0], [1.0, 1.0], [2.0, 2.0]]
    with pytest.raises(ValueError, match="one dtype"):
        F._pack([{"a": torch.zeros(()), "b": torch.zeros((), dtype=torch.int32)}])


def test_a_card_request_without_cuda_raises(monkeypatch):
    """No card and a request for one: every fused entry point raises before
    it runs a step; nothing falls back to the CPU's plain loop."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = repro_torch.make("CartPole-v1")
    cfg = TD.DQNConfig(memory_size=8)
    calls = []
    monkeypatch.setattr(F, "_plain_chunk",
                        lambda *a: calls.append(a) or pytest.fail("ran"))
    for device in (None, "cuda"):
        for entry in (
                lambda: TD.train_compiled(env, cfg, 2, R.PRNGKey(0),
                                          fused=True, device=device),
                lambda: TPPO.train(env, TPPO.PPOConfig(num_envs=2,
                                                       rollout_len=2), 1,
                                   R.PRNGKey(0), fused=True, device=device),
                lambda: F.fleet(env, [0, 1], 2, cfg=cfg, device=device)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                entry()
    assert calls == []
