"""The port's async pool (`repro_torch.pool.AsyncEnvPool`) and its masked
step against the JAX package, on the CPU.

  - scripted traffic (admit / step a random subset of lanes / release on a
    spent budget) through the port's pool, JAX's `AsyncEnvPool` on the
    same script, and each session alone through the port's 1-lane
    `EnvPool(backend="vmap")`: every session's stream equal in all three;
    the script has a lane idle across an episode reset, the one case that
    shows an idle lane's auto-reset key drifting;
  - the masked "torch" step against the masked vmap step, through two
    pools, across episode ends (tests/test_torch_async_step.py holds the
    facade and `fused_step(active=)` against JAX);
  - committed goldens through `send`/`recv` (tests/test_golden.py's
    `async_trace` recipe); protocol errors, `min_ready` across threads,
    returned obs that do not alias the table, `pack`/`unpack`, and every
    registry id hosted or refused with `AsyncUnsupportedError`.

The JAX side runs inside `jax.threefry_partitionable(False)`, the layout
the goldens were made with. Ints, bools and keys exact; floats to
1e-5/1e-6, rendered frames to atol 1e-5 (tests/test_torch_pool.py says
why).
"""
import json
import pathlib
import threading

import jax
import numpy as np
import pytest
import torch

from torch.utils._pytree import tree_leaves

import repro_torch
from repro.pool import AsyncEnvPool as JAsyncEnvPool
from repro_torch import random as R
from repro_torch.core.registry import registered
from repro_torch.core.spaces import sample_batch
from repro_torch.pool import (AsyncEnvPool, AsyncUnsupportedError, EnvPool,
                              make_vec)
from repro_torch.pool.async_pool import host_split, pack, seed_keys, unpack

CPU = "cpu"
GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
FRAME_ATOL = 1e-5
REPLAY_IDS = ("CartPole-v1", "FrozenLake-v0", "Pong-raw", "Pong-v0")
#: 6 sessions through 3 slots; the long budgets run past episode ends,
#: and with the schedule's seed a lane idles across a reset on every id
BUDGETS = (16, 5, 20, 3, 12, 6)
NUM_SLOTS, SCHEDULE_SEED = 3, 1


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


def _match(want, got, what, frame=False):
    want, got = _np(want), _np(got)
    assert want.shape == got.shape and want.dtype == got.dtype, (
        what, want.shape, got.shape, want.dtype, got.dtype)
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=FRAME_ATOL if frame else 1e-6,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _session_actions(space, sid, budget):
    key = R.PRNGKey(9000 + sid, CPU)
    return [sample_batch(space, R.fold_in(key, t), 1)[0].numpy()
            for t in range(budget)]


def _schedule(budgets, num_slots, seed=0):
    """The scripted traffic as ticks of (admits [(sid, slot)], ready slots,
    releases): FIFO arrivals into the lowest free slots, a random subset of
    the hosted lanes sending each tick, a departure when a budget is
    spent. It depends on nothing a pool computes."""
    rng = np.random.default_rng(seed)
    queue, slot_sid, steps, ticks = list(range(len(budgets))), {}, {}, []
    while queue or slot_sid:
        admits = []
        for slot in range(num_slots):
            if slot not in slot_sid and queue:
                sid = queue.pop(0)
                slot_sid[slot], steps[sid] = sid, 0
                admits.append((sid, slot))
        ready = sorted(slot_sid)
        if len(ready) > 1 and rng.random() < 0.5:
            ready = sorted(rng.choice(ready, size=len(ready) - 1,
                                      replace=False).tolist())
        for slot in ready:
            steps[slot_sid[slot]] += 1
        releases = [s for s in sorted(slot_sid)
                    if steps[slot_sid[s]] >= budgets[slot_sid[s]]]
        ticks.append((admits, ready, {s: slot_sid[s] for s in slot_sid},
                      releases))
        for s in releases:
            del slot_sid[s]
    return ticks


def _replay(pool, ticks, seeds, acts):
    """Each session's (first obs, [(obs, reward, done, terminal_obs)])."""
    first, rows = {}, {sid: [] for sid in seeds}
    for admits, ready, hosted, releases in ticks:
        for sid, slot in admits:
            _, obs = pool.admit(seed=seeds[sid], slot=slot)
            first[sid] = _np(obs)
        pool.send(np.stack([acts[hosted[s]][len(rows[hosted[s]])]
                            for s in ready]), np.asarray(ready))
        obs, rew, done, info, ids = pool.recv()
        assert list(ids) == ready
        for i, slot in enumerate(ready):
            rows[hosted[slot]].append(
                (obs[i], rew[i], done[i], info["terminal_obs"][i]))
        for s in releases:
            pool.release(s)
    return first, rows


def _idles_across_a_reset(ticks, rows) -> bool:
    """Whether some session idled (hosted, not sending) at a tick before
    one of its steps that ended an episode."""
    idle_at = {}
    steps = {}
    for admits, ready, hosted, _ in ticks:
        for slot, sid in hosted.items():
            if slot not in ready:
                idle_at.setdefault(sid, []).append(steps.get(sid, 0))
            else:
                steps[sid] = steps.get(sid, 0) + 1
    for sid, idles in idle_at.items():
        dones = [t for t, r in enumerate(rows[sid]) if bool(r[2])]
        if any(k <= t for k in idles for t in dones):
            return True
    return False


@pytest.mark.parametrize("name", REPLAY_IDS)
def test_traffic_replay_matches_solo_and_jax(name):
    pixel = name == "Pong-v0"
    ticks = _schedule(BUDGETS, NUM_SLOTS, SCHEDULE_SEED)
    seeds = {sid: 50 + sid for sid in range(len(BUDGETS))}
    space = repro_torch.make(name).action_space
    acts = {sid: _session_actions(space, sid, b)
            for sid, b in enumerate(BUDGETS)}

    pool = AsyncEnvPool(name, NUM_SLOTS, device=CPU)
    assert pool.backend == "torch"
    first, rows = _replay(pool, ticks, seeds, acts)
    assert _idles_across_a_reset(ticks, rows), (
        f"{name}: no lane idles across a reset; the script would not see "
        "an idle lane's key drift")
    j_first, j_rows = _replay(JAsyncEnvPool(name, NUM_SLOTS), ticks, seeds,
                              acts)

    for sid, budget in enumerate(BUDGETS):
        solo = EnvPool(name, 1, backend="vmap", device=CPU)
        s_first = solo.reset(seed=seeds[sid])[0]
        assert len(rows[sid]) == len(j_rows[sid]) == budget
        for want, what in ((s_first, "solo"), (j_first[sid], "jax")):
            _match(want, first[sid], f"{name} sid{sid} first obs vs {what}",
                   frame=pixel)
        for t, a in enumerate(acts[sid]):
            obs, rew, done, info = solo.step(torch.as_tensor(a)[None])
            s_row = (obs[0], rew[0], done[0], info["terminal_obs"][0])
            for want, what in ((s_row, "solo"), (j_rows[sid][t], "jax")):
                for i, field in enumerate(("obs", "reward", "done",
                                           "terminal_obs")):
                    _match(want[i], rows[sid][t][i],
                           f"{name} sid{sid} step{t} {field} vs {what}",
                           frame=pixel and field in ("obs", "terminal_obs"))


def _leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(tree_leaves(a), tree_leaves(b), strict=True))


def test_masked_torch_step_matches_masked_vmap_step():
    """The fused ("torch") and vmap async pools agree lane for lane under
    partial activity, across several episode ends."""
    fused = AsyncEnvPool("CartPole-v1", 4, backend="torch", device=CPU)
    ref = AsyncEnvPool("CartPole-v1", 4, backend="vmap", device=CPU)
    for pool in (fused, ref):
        for sid in range(3):          # slot 3 stays empty
            pool.admit(seed=sid)
    for t in range(40):
        ready = [0, 2] if t % 3 else [0, 1, 2]
        acts = np.full(len(ready), t % 2, np.int32)
        for pool in (fused, ref):
            pool.send(acts, np.asarray(ready))
        got, want = fused.recv(), ref.recv()
        assert list(got[4]) == list(want[4]) == ready
        for i in range(3):
            _match(want[i], got[i], f"tick{t} {i}")
        for k in want[3]:
            _match(want[3][k], got[3][k], f"tick{t} {k}")
    assert _leaves_equal(fused._state.key, ref._state.key)


@pytest.mark.parametrize("name", ["CartPole-v1", "Multitask-v0"])
def test_goldens_through_send_recv(name):
    """tests/test_golden.py's `async_trace` recipe through the port:
    `reset(seed)`, then `recv(key=fold_in(key, t))` each step, on the
    megastep and on the vmap step (chip_smoke.py replays all 28 on the
    card)."""
    want = json.loads((GOLDEN_DIR / f"{name}.json").read_text())
    batch = want["batch"]
    pool = make_vec(name, batch, backend="async", device=CPU)
    key = R.PRNGKey(sum(map(ord, name)), CPU)
    obs0 = pool.reset(seed=sum(map(ord, name)))
    rows = []
    for t in range(want["steps"]):
        a = sample_batch(pool.action_space, R.fold_in(key, 1000 + t), batch)
        pool.send(a, np.arange(batch))
        obs, rew, done, _, _ = pool.recv(key=R.fold_in(key, t))
        rows.append([float(np.asarray(obs, np.float64).sum()),
                     float(np.asarray(rew, np.float64).sum()),
                     int(np.asarray(done).sum())])
    np.testing.assert_allclose(float(obs0.double().sum()),
                               want["reset_obs_sum"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rows, want["rows"], rtol=1e-4, atol=1e-4,
                               err_msg=f"{name}: async trace left its golden")


def test_send_recv_protocol_errors():
    pool = AsyncEnvPool("CartPole-v1", 2, device=CPU)
    with pytest.raises(RuntimeError, match="no actions in flight"):
        pool.recv()
    sid, _ = pool.admit(seed=0)
    with pytest.raises(ValueError, match="no running session"):
        pool.send(np.zeros(1, np.int32), [1 - sid])
    pool.send(np.zeros(1, np.int32), [sid])
    with pytest.raises(ValueError, match="already in flight"):
        pool.send(np.zeros(1, np.int32), [sid])
    with pytest.raises(RuntimeError, match="in flight"):
        pool.state_dict()
    pool.recv()
    with pytest.raises(ValueError, match="exactly one of"):
        pool.admit(seed=1, key=R.PRNGKey(1, CPU))
    with pytest.raises(ValueError, match="already hosts"):
        pool.admit(seed=1, slot=sid)
    pool.admit(seed=1)
    with pytest.raises(RuntimeError, match="no free slot"):
        pool.admit(seed=2)
    pool.release(sid)
    with pytest.raises(ValueError, match="no running session"):
        pool.release(sid)
    with pytest.raises(ValueError, match="batch"):
        pool.send(np.zeros(2, np.int32), [1 - sid])
    with pytest.raises(RuntimeError, match="reset"):
        pool.step(np.zeros(2, np.int32))
    pool.reset(seed=0)
    pool.release(0)
    with pytest.raises(RuntimeError, match="every slot active"):
        pool.step(np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="slots"):
        AsyncEnvPool("CartPole-v1", 3, device=CPU).load_state_dict(
            pool.state_dict())


def test_returned_obs_do_not_alias_the_table():
    """The table is written in place (admit, admit_lane): what reset, admit
    and lane_state returned stays as it was."""
    pool = AsyncEnvPool("CartPole-v1", 2, device=CPU)
    obs0 = pool.reset(seed=0)
    kept = obs0.clone()
    pool.release(1)
    _, first = pool.admit(seed=5, slot=1)
    kept_first = first.clone()
    lane = pool.lane_state(1)
    kept_lane = lane["obs"].copy()
    for t in range(3):
        pool.send(np.ones(2, np.int32), [0, 1])
        pool.recv()
    pool.release(1)
    pool.admit_lane(lane, slot=1)
    pool.release(0)
    pool.admit(seed=9, slot=0)
    assert torch.equal(obs0, kept) and torch.equal(first, kept_first)
    np.testing.assert_array_equal(lane["obs"], kept_lane)


def test_unsupported_backend_and_registry_completeness():
    """Every registry id hosts on the pool (CPU) or refuses with the named
    error; a backend without fused support refuses, "auto" degrades to the
    masked vmap step."""
    with pytest.raises(AsyncUnsupportedError, match="fused megastep"):
        AsyncEnvPool("Multitask-v0", 2, backend="torch", device=CPU)
    assert AsyncEnvPool("Multitask-v0", 2, device=CPU).backend == "vmap"
    with pytest.raises(ValueError, match="unknown async step backend"):
        AsyncEnvPool("CartPole-v1", 2, backend="pallas", device=CPU)
    with pytest.raises(ValueError, match="CUDA device"):
        AsyncEnvPool("CartPole-v1", 2, backend="cuda", device=CPU)
    hosted, refused = [], []
    for name in registered():
        try:
            AsyncEnvPool(name, 1, device=CPU)
            hosted.append(name)
        except AsyncUnsupportedError:
            refused.append(name)
    assert len(hosted) == 28 and not refused, refused


def test_recv_blocks_for_min_ready_across_threads():
    pool = AsyncEnvPool("CartPole-v1", 2, device=CPU)
    for sid in range(2):
        pool.admit(seed=sid)
    pool.send(np.zeros(1, np.int32), [0])

    def late_client():
        pool.send(np.ones(1, np.int32), [1])

    timer = threading.Timer(0.05, late_client)
    timer.start()
    try:
        _, _, _, _, ids = pool.recv(max_wait=5.0, min_ready=2)
    finally:
        timer.join()
    assert list(ids) == [0, 1]


def test_pack_unpack_and_host_split():
    """One buffer for a recv's outputs, read back exactly; the recv key
    chain's host split is `random.split`."""
    parts = [torch.arange(6, dtype=torch.float32).reshape(2, 3),
             torch.tensor([True, False]),
             torch.tensor([[7, -1]], dtype=torch.int32),
             torch.tensor([0.5, -2.0])]
    buf, layout = pack(parts)
    assert buf.dtype == torch.uint8 and buf.numel() == 24 + 2 + 8 + 8
    for want, got in zip(parts, unpack(buf.numpy(), layout), strict=True):
        np.testing.assert_array_equal(got, want.numpy())
        assert got.dtype == want.numpy().dtype
    key = np.array([12, 0x5C0], np.int64)
    pair = R.split(torch.as_tensor(key))
    a, b = host_split(key)
    assert a.tolist() == pair[0].tolist() and b.tolist() == pair[1].tolist()
    seeds = [0, 7, 2**32 + 5, 123456789]
    want = [R.split(R.PRNGKey(s, CPU), 1)[0].tolist() for s in seeds]
    assert seed_keys(seeds).tolist() == want


def test_admit_many_is_admit_per_seed():
    """One batched reset of several fresh sessions gives each the rows
    `admit(seed=s)` gives it alone."""
    one = AsyncEnvPool("Maze-v0", 4, device=CPU)
    many = AsyncEnvPool("Maze-v0", 4, device=CPU)
    firsts = [one.admit(seed=s, slot=slot)[1]
              for s, slot in ((3, 2), (9, 0), (4, 3))]
    slots, obs = many.admit_many([3, 9, 4], [2, 0, 3])
    assert slots == [2, 0, 3] and torch.equal(obs, torch.stack(firsts))
    for x, y in zip(tree_leaves(one._state), tree_leaves(many._state)):
        assert torch.equal(x[[2, 0, 3]], y[[2, 0, 3]])
    with pytest.raises(ValueError, match="distinct"):
        many.admit_many([1, 2], [1, 1])
    with pytest.raises(RuntimeError, match="no free slot"):
        many.admit_many([1, 2])
