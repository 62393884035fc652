"""The port's runtime and checkpointing (`repro_torch.runtime`,
`repro_torch.checkpoint`, `pool.ShardedEnvPool`) against the JAX package,
on the CPU.

  - `failures.py` (heartbeats, the fault injector, recovery plans) and
    `propose_mesh` against JAX's on the same scripted clocks;
  - `CheckpointManager`: serialised non-blocking writes and keep-k, writer
    errors surfaced once, close, atomicity under a "preempt_save" fault in
    `_pre_replace_hook`, the meta sidecar, a gather complete when `save`
    returns; leaf paths equal to `jax.tree_util.keystr` for the pools'
    snapshots; a JAX-written checkpoint restored into the port continuing
    the committed golden, and a port-written one restored into JAX's pool
    (lock-step and async) continuing it too;
  - kill-and-resume through `RolloutSupervisor` against the committed
    goldens: CartPole-v1 and Pendulum-v1 lock-step on "vmap" and "torch",
    Maze-v0 on "torch", FrozenLake-v0 through send/recv; a 2-shard `ShardedEnvPool`
    over ("cpu", "cpu") killed and recovered onto 1 shard, equal to a
    1-shard run from the same snapshot; a 1-shard `ShardedEnvPool` bit for
    bit with `EnvPool`, and with JAX's on `default_pool_mesh(1)`.

The JAX side runs inside `jax.threefry_partitionable(False)`, the layout
the goldens were made with. Goldens at 1e-4; ints, bools and keys exact,
floats to 1e-5/1e-6 against JAX.
"""
import dataclasses
import json
import pathlib
import threading

import jax
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

import repro_torch
from repro.core import make as jax_make
from repro.core.spaces import sample_batch as jax_sample_batch
from repro.pool import AsyncEnvPool as JAsyncEnvPool
from repro.pool import EnvPool as JEnvPool
from repro.pool import ShardedEnvPool as JShardedEnvPool
from repro.pool import default_pool_mesh as jax_default_pool_mesh
from repro.runtime import RolloutSupervisor as JRolloutSupervisor
from repro.runtime import elastic as JE
from repro.runtime import failures as JF
from repro_torch import random as R
from repro_torch.checkpoint.manager import (CheckpointManager,
                                            flatten_with_path)
from repro_torch.core.spaces import sample_batch
from repro_torch.pool import AsyncEnvPool, EnvPool, ShardedEnvPool
from repro_torch.runtime import (DeviceLossError, FaultInjector,
                                 HeartbeatMonitor, RolloutSupervisor,
                                 build_mesh, elastic, failures)

CPU = "cpu"
GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
STEPS, BATCH = 32, 2
KILL_AT, SNAP_EVERY = 20, 8        # mid-flight, after the step-16 snapshot
ASYNC_ID = "FrozenLake-v0"


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


def _golden_rows(name):
    return np.asarray(json.loads((GOLDEN_DIR / f"{name}.json").read_text())
                      ["rows"], np.float64)


def _row(obs, rew, done):
    return [float(np.asarray(_np(obs), np.float64).sum()),
            float(np.asarray(_np(rew), np.float64).sum()),
            int(np.asarray(_np(done)).sum())]


def _golden_stream(name):
    """The golden recipe's key and actions (tests/test_golden.py::trace)."""
    key = R.PRNGKey(sum(map(ord, name)), CPU)
    space = repro_torch.make(name).action_space
    acts = [sample_batch(space, R.fold_in(key, 1000 + t), BATCH)
            for t in range(STEPS)]
    return key, acts


# -- failures and meshes against JAX's ----------------------------------------

def _failure_script(F):
    """One scripted run of the host-side failure harness of package `F`;
    returns everything it observed."""
    clk = [0.0]
    out = []
    mon = F.HeartbeatMonitor(4, timeout_s=2.0, clock=lambda: clk[0])
    inj = F.FaultInjector([F.Fault(3.0, "stall", 7)], clock=lambda: clk[0])
    inj.schedule(1.0, "host_death", 2)
    inj.schedule(1.0, "device_loss", 1)
    inj.schedule(5.0, "preempt_save", "x")
    for step, now in enumerate((0.5, 1.0, 1.5, 3.0, 4.0, 6.0)):
        clk[0] = now
        for h in range(4):
            if not (h == 2 and now >= 1.0):
                mon.beat(h, step * 10 + h)
        out.append((mon.dead_hosts(), mon.healthy(), mon.quorum_step(),
                    [(f.at, f.kind, f.arg) for f in inj.due(
                        kinds=None if step % 2 else ("stall", "device_loss",
                                                     "host_death"))]))
    out.append(([(f.kind, f.fired) for f in inj.fired()],
                [(f.kind, f.fired) for f in inj.pending()]))
    for ckpt in (None, 40):
        plan = F.plan_recovery(mon, devices_per_host=4, checkpoint_step=ckpt)
        out.append(dataclasses.asdict(plan))
    err = F.DeviceLossError(3)
    out.append((err.n_lost, str(err), str(F.DeviceLossError())))
    out.append(dataclasses.asdict(F.HostStatus(1, 2.0, 3)))
    return out


def test_failures_match_jax_on_scripted_clocks():
    assert _failure_script(failures) == _failure_script(JF)


def test_propose_mesh_matches_jax():
    for n in range(1, 65):
        for prefer in (1, 2, 4, 16):
            assert (elastic.propose_mesh(n, prefer)
                    == JE.propose_mesh(n, prefer)), (n, prefer)
    for mod in (elastic, JE):
        with pytest.raises(ValueError, match="no devices"):
            mod.propose_mesh(0)


def test_build_mesh_counts_visible_devices():
    assert build_mesh(1, device_type=CPU) == (torch.device(CPU),)
    assert build_mesh(device_type=CPU) == (torch.device(CPU),)
    with pytest.raises(ValueError, match="1 visible"):
        build_mesh(2, device_type=CPU)


# -- the checkpoint manager ----------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 4, generator=g),
            "n": {"step": torch.tensor(seed, dtype=torch.int32)},
            "k": R.PRNGKey(seed, CPU)}


def _zeros_like(tree):
    from torch.utils._pytree import tree_map

    return tree_map(torch.zeros_like, tree)


def test_nonblocking_saves_never_overlap_and_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    inside, lock = [], threading.Lock()

    def hook(tmp):
        with lock:
            inside.append(tmp)
            assert len(inside) == 1, "two writes in the critical section"
        with lock:
            inside.pop()

    mgr._pre_replace_hook = hook
    for step in range(6):
        mgr.save(step, _tree(step), blocking=False)
    mgr.close()
    assert mgr.all_steps() == [4, 5]
    got = mgr.restore(_zeros_like(_tree()))
    for a, b in zip(tree_leaves(got), tree_leaves(_tree(5)), strict=True):
        assert torch.equal(a, b)


def test_writer_errors_surface_once(tmp_path):
    mgr = CheckpointManager(str(tmp_path))

    def boom(tmp):
        if "step_0000000001" in tmp:
            raise OSError("disk gone")

    mgr._pre_replace_hook = boom
    mgr.save(1, _tree(), blocking=False)
    with pytest.raises(OSError, match="disk gone"):
        mgr.wait()
    mgr.wait()                         # consumed, not sticky
    mgr.save(1, _tree(), blocking=False)
    with pytest.raises(OSError):       # the serialising wait() re-raises
        mgr.save(2, _tree())
    mgr.save(2, _tree())
    assert mgr.latest_step() == 2
    mgr.close()
    with pytest.raises(RuntimeError, match="closed"):
        mgr.save(3, _tree())
    with CheckpointManager(str(tmp_path / "cm")) as cm:
        cm.save(1, _tree(), blocking=False)
    assert cm.latest_step() == 1       # the context manager joined it


def test_midsave_preemption_preserves_previous_checkpoint(tmp_path):
    """A "preempt_save" fault kills a write after its tmp dir is complete
    and before the atomic rename: the previous checkpoint survives and
    restores, and the next save succeeds."""
    clk = [0.0]
    inj = FaultInjector(clock=lambda: clk[0])
    mgr = CheckpointManager(str(tmp_path), keep=3)

    def preempt(tmp):
        for f in inj.due(kinds=("preempt_save",)):
            raise KeyboardInterrupt(f"preempted mid-save ({f.arg})")

    mgr._pre_replace_hook = preempt
    mgr.save(10, _tree(7))
    inj.schedule(1.0, "preempt_save", "host preempted")
    clk[0] = 2.0
    with pytest.raises(KeyboardInterrupt):
        mgr.save(20, _tree(8))
    assert mgr.all_steps() == [10]
    assert torch.equal(mgr.restore(_zeros_like(_tree()))["w"], _tree(7)["w"])
    inj.schedule(3.0, "preempt_save")
    clk[0] = 4.0
    mgr.save(30, _tree(9), blocking=False)
    with pytest.raises(KeyboardInterrupt):
        mgr.wait()
    mgr.save(20, _tree(8))             # the stale tmp dir is cleared
    assert mgr.all_steps() == [10, 20]


def test_meta_and_a_gather_complete_at_save(tmp_path):
    """`meta=` round-trips; the leaves are copied before `save` returns, so
    writing the tensors in place after a non-blocking save changes nothing
    on disk."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree(3)
    want = tree["w"].clone()
    mgr.save(1, tree, blocking=False, meta={"sessions": {"3": {"steps": 4}}})
    tree["w"].mul_(0).add_(5)
    mgr.save(2, _tree())
    assert mgr.read_meta(1) == {"sessions": {"3": {"steps": 4}}}
    assert mgr.read_meta(2) is None and mgr.read_meta() is None
    assert torch.equal(mgr.restore(_zeros_like(tree), step=1)["w"], want)
    numpy_tmpl = {"w": np.zeros((8, 4), np.float64)}
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore({"v": np.zeros(2)}, step=1)
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"w": np.zeros((4, 8))}, step=1)
    got = mgr.restore({**numpy_tmpl, "n": {"step": np.int64(0)},
                       "k": np.zeros(2, np.uint32)}, step=1)
    assert got["w"].dtype == np.float64 and got["n"]["step"] == 3
    tree_json = json.loads((tmp_path / "step_0000000001" / "tree.json")
                           .read_text())
    assert sorted(tree_json["leaves"]) == ["['k']", "['n']['step']", "['w']"]


def _jax_paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): (np.shape(x), np.asarray(x).dtype)
            for p, x in flat}


def _port_paths(tree):
    return {p: (tuple(np.shape(x)), np.asarray(x).dtype)
            for p, x in flatten_with_path(tree)}


@pytest.mark.parametrize("name", ["CartPole-v1", "Pong-v0", "Multitask-v0"])
def test_leaf_paths_are_jax_keystr(name):
    """A port snapshot's leaf paths, shapes and dtypes are those JAX's
    `keystr` gives its pool's snapshot: the lock-step pool with the
    supervisor's step counter, and (CartPole-v1) the async pool. A grid
    id's (Maze-v0) cross in `test_jax_checkpoint_restores_into_the_port`."""
    jpool = JEnvPool(name, BATCH)
    jpool.reset(seed=0)
    pool = EnvPool(name, BATCH, device=CPU)
    pool.reset(seed=0)
    jt = {**jpool.state_dict(), "t": np.asarray(0, np.int64)}
    pt = {**pool.state_dict(), "t": np.asarray(0, np.int64)}
    assert _port_paths(pt) == _jax_paths(jt)
    if name == "CartPole-v1":
        assert (_port_paths(AsyncEnvPool(name, 3, device=CPU).state_dict())
                == _jax_paths(JAsyncEnvPool(name, 3).state_dict()))


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """JAX's supervisor snapshots its pool (steps 8 and 16) in JAX's
    format; the port's supervisor restores step 16 into its pool, which
    continues the committed golden trace."""
    name = "Maze-v0"
    d = str(tmp_path)
    env = jax_make(name)
    jkey = jax.random.PRNGKey(sum(map(ord, name)))
    jsup = JRolloutSupervisor(JEnvPool(env, BATCH), d, snapshot_every=8,
                              blocking_snapshots=True)
    jsup.reset(seed=sum(map(ord, name)))
    for t in range(16):
        jsup.step(jax_sample_batch(env.action_space,
                                   jax.random.fold_in(jkey, 1000 + t), BATCH),
                  key=jax.random.fold_in(jkey, t))
    jsup.close()
    key, acts = _golden_stream(name)
    sup = RolloutSupervisor(EnvPool(name, BATCH, device=CPU), d)
    assert sup.restore() == 16
    rows = [_row(*sup.step(acts[t], key=R.fold_in(key, t))[:3])
            for t in range(16, STEPS)]
    np.testing.assert_allclose(rows, _golden_rows(name)[16:], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("async_pool", (False, True))
def test_port_checkpoint_restores_into_jax(async_pool, tmp_path):
    """The port's supervisor snapshots its pool at step 16; JAX's supervisor
    restores it into JAX's pool, which continues the committed golden
    trace (lock-step: Pendulum-v1, float actions; async: FrozenLake-v0
    through send/recv, the active mask and both key chains crossing)."""
    name = ASYNC_ID if async_pool else "Pendulum-v1"
    key, acts = _golden_stream(name)
    pool = (AsyncEnvPool(name, BATCH, device=CPU) if async_pool
            else EnvPool(name, BATCH, device=CPU))
    sup = RolloutSupervisor(pool, str(tmp_path), snapshot_every=16,
                            blocking_snapshots=True)
    sup.reset(seed=sum(map(ord, name)))
    for t in range(16):
        if async_pool:
            sup.send(acts[t], np.arange(BATCH))
            sup.recv(key=R.fold_in(key, t))
        else:
            sup.step(acts[t], key=R.fold_in(key, t))
    jkey = jax.random.PRNGKey(sum(map(ord, name)))
    jpool = (JAsyncEnvPool(name, BATCH) if async_pool
             else JEnvPool(name, BATCH))
    jsup = JRolloutSupervisor(jpool, str(tmp_path))
    assert jsup.restore() == 16
    rows = []
    for t in range(16, STEPS):
        a = np.asarray(acts[t])
        if async_pool:
            jsup.send(a, np.arange(BATCH))
            out = jsup.recv(key=jax.random.fold_in(jkey, t))
        else:
            out = jsup.step(a, key=jax.random.fold_in(jkey, t))
        rows.append(_row(*out[:3]))
    np.testing.assert_allclose(rows, _golden_rows(name)[16:], rtol=1e-4,
                               atol=1e-4)
    if async_pool:
        snap = jpool.state_dict()   # the port's recv key chain, advanced
        assert snap["active"].all() and snap["recv_key"].dtype == np.uint32


# -- kill-and-resume against the committed goldens -----------------------------

@pytest.mark.parametrize("name,backend", [
    ("CartPole-v1", "vmap"), ("CartPole-v1", "torch"), ("Maze-v0", "torch"),
    ("Pendulum-v1", "vmap"), ("Pendulum-v1", "torch")])
def test_kill_and_resume_matches_golden_lockstep(name, backend, tmp_path):
    """save -> injected device loss -> recover() -> restore resumes the
    committed golden trajectory (`step(key=)` replays its key chain)."""
    key, acts = _golden_stream(name)
    clk = [0.0]
    inj = FaultInjector(clock=lambda: clk[0])
    sup = RolloutSupervisor(EnvPool(name, BATCH, backend=backend, device=CPU),
                            str(tmp_path), snapshot_every=SNAP_EVERY,
                            blocking_snapshots=True, injector=inj)
    sup.reset(seed=sum(map(ord, name)))
    rows, t, killed = [None] * STEPS, 0, False
    while t < STEPS:
        if t == KILL_AT and not killed:
            inj.schedule(0.5, "device_loss", 1)
            clk[0] = 1.0
        try:
            obs, rew, done, _ = sup.step(acts[t], key=R.fold_in(key, t))
        except DeviceLossError:
            assert not killed, "fault fired twice"
            killed = True
            plan = sup.recover()
            assert plan["restored_step"] == (KILL_AT // SNAP_EVERY) * SNAP_EVERY
            assert plan["mesh"] == [CPU] and sup.pool.backend == backend
            t = sup.t
            continue
        rows[t] = _row(obs, rew, done)
        t += 1
    assert killed and sup.recoveries == 1
    np.testing.assert_allclose(rows, _golden_rows(name), rtol=1e-4,
                               atol=1e-4, err_msg=f"{name} ({backend})")


def test_kill_and_resume_matches_golden_async(tmp_path):
    """The same through send/recv: the snapshot holds the whole slot table
    (active mask, both key chains), and the rebuilt pool replays the golden
    recv-key stream."""
    name = ASYNC_ID
    key, acts = _golden_stream(name)
    clk = [0.0]
    inj = FaultInjector(clock=lambda: clk[0])
    sup = RolloutSupervisor(AsyncEnvPool(name, BATCH, device=CPU),
                            str(tmp_path), snapshot_every=SNAP_EVERY,
                            blocking_snapshots=True, injector=inj)
    sup.reset(seed=sum(map(ord, name)))
    rows, t, killed = [None] * STEPS, 0, False
    while t < STEPS:
        if t == KILL_AT and not killed:
            inj.schedule(0.5, "device_loss", 1)
            clk[0] = 1.0
        try:
            sup.send(acts[t], np.arange(BATCH))
        except DeviceLossError:
            killed = True
            sup.recover()
            assert type(sup.pool) is AsyncEnvPool
            t = sup.t
            continue
        obs, rew, done, _, _ = sup.recv(key=R.fold_in(key, t))
        rows[t] = _row(obs, rew, done)
        t += 1
    assert killed and sup.recoveries == 1
    np.testing.assert_allclose(rows, _golden_rows(name), rtol=1e-4, atol=1e-4)


def test_restore_resets_only_a_pool_without_a_carry(tmp_path):
    """`restore` resets a fresh lock-step pool for its template, and goes
    straight to `state_dict()` on an async pool, which builds its table
    itself: the restored table is the snapshot's either way."""
    sup = RolloutSupervisor(AsyncEnvPool(ASYNC_ID, 4, device=CPU),
                            str(tmp_path), blocking_snapshots=True)
    sup.reset(seed=5)
    sup.send(np.ones(4, np.int32), np.arange(4))
    sup.recv()
    sup.snapshot()
    want = sup.pool.state_dict()

    fresh = AsyncEnvPool(ASYNC_ID, 4, device=CPU)
    fresh.reset = None   # a call would raise
    assert fresh.has_carry and sup.restore(pool=fresh) == sup.t
    for a, b in zip(tree_leaves(want), tree_leaves(fresh.state_dict()),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    pool = EnvPool("MountainCar-v0", 4, device=CPU)
    assert not pool.has_carry
    pool.reset(seed=0)
    assert pool.has_carry


def test_snapshot_restores_into_a_fresh_pool_and_is_a_copy(tmp_path):
    """A snapshot restored into a new pool continues as the original does;
    stepping after a snapshot (the carry is replaced, frames and table
    rows are written in place) does not change it."""
    key = R.PRNGKey(3, CPU)
    zeros = np.zeros(4, np.int32)
    sup = RolloutSupervisor(EnvPool("MountainCar-v0", 4, device=CPU),
                            str(tmp_path), snapshot_every=5,
                            blocking_snapshots=True)
    sup.reset(seed=3)
    for t in range(5):
        sup.step(zeros, key=R.fold_in(key, t))
    snap = sup.pool.state_dict()
    frozen = [np.array(x, copy=True) for x in tree_leaves(snap)]
    ref = [sup.step(zeros, key=R.fold_in(key, t))[0].clone()
           for t in range(5, 8)]
    for a, b in zip(frozen, tree_leaves(snap), strict=True):
        np.testing.assert_array_equal(a, b)
    sup2 = RolloutSupervisor(EnvPool("MountainCar-v0", 4, device=CPU),
                             str(tmp_path))
    assert sup2.restore() == 5
    for t in range(5, 8):
        assert torch.equal(sup2.step(zeros, key=R.fold_in(key, t))[0],
                           ref[t - 5])


def test_monitor_times_out_a_host_killed_by_the_injector(tmp_path):
    clk = [0.0]
    inj = FaultInjector(clock=lambda: clk[0])
    mon = HeartbeatMonitor(4, timeout_s=5.0, clock=lambda: clk[0])
    sup = RolloutSupervisor(EnvPool("CartPole-v1", 4, device=CPU),
                            str(tmp_path), snapshot_every=4,
                            blocking_snapshots=True, injector=inj,
                            monitor=mon)
    sup.reset(seed=0)
    for _ in range(4):
        sup.step(np.zeros(4, np.int32))
    assert mon.healthy()
    inj.schedule(1.0, "host_death", 3)
    clk[0] = 2.0
    sup.step(np.zeros(4, np.int32))
    clk[0] = 10.0
    sup.step(np.zeros(4, np.int32))
    assert mon.dead_hosts() == [3]
    plan = sup.recover()                 # 3 survivors, clamped to the CPU
    assert plan["n_devices"] == 1 and plan["restored_step"] == 4
    assert "[3]" in plan["notes"]


# -- the sharded pool ------------------------------------------------------------

@pytest.mark.parametrize("backend", ("vmap", "torch"))
def test_two_shards_recover_onto_one(backend, tmp_path):
    """A 2-shard rollout over ("cpu", "cpu"), a device loss, `recover()`
    onto one device: the continuation equals a 1-device pool restored from
    the same snapshot, bit for bit. Each shard's lanes are a lane pool of
    their own, reset from the key folded by the shard index."""
    b, snap, kill, end = 8, 8, 12, 16
    key = R.PRNGKey(0, CPU)
    zeros = np.zeros(b, np.int32)
    clk = [0.0]
    inj = FaultInjector(clock=lambda: clk[0])
    pool = ShardedEnvPool("CartPole-v1", b, mesh=(CPU, CPU), backend=backend)
    sup = RolloutSupervisor(pool, str(tmp_path), snapshot_every=snap,
                            blocking_snapshots=True, injector=inj)
    obs = sup.reset(seed=0)
    half = repro_torch.make_vec("CartPole-v1", b // 2, backend=backend,
                                device=CPU)
    for i in range(2):
        _, want = half.venv.reset(R.fold_in(R.PRNGKey(0, CPU), i))
        assert torch.equal(obs[i * 4:(i + 1) * 4], want)
    for t in range(kill):
        sup.step(zeros, key=R.fold_in(key, t))

    osup = RolloutSupervisor(EnvPool("CartPole-v1", b, backend=backend,
                                     device=CPU), str(tmp_path))
    osup.restore(step=snap)
    ref = [osup.step(zeros, key=R.fold_in(key, t))[0].clone()
           for t in range(snap, end)]

    inj.schedule(1.0, "device_loss", 1)
    clk[0] = 2.0
    with pytest.raises(DeviceLossError):
        sup.step(zeros, key=R.fold_in(key, kill))
    plan = sup.recover(n_devices=1)
    assert plan["restored_step"] == snap and plan["mesh_shape"] == (1, 1)
    assert type(sup.pool) is ShardedEnvPool and sup.pool.n_shards == 1
    got = [sup.step(zeros, key=R.fold_in(key, t))[0]
           for t in range(sup.t, end)]
    assert all(torch.equal(a, b) for a, b in zip(ref, got, strict=True))


def test_one_shard_is_envpool_and_jax_sharded_pool():
    """On one device the sharded pool folds no key: bit for bit the
    port's EnvPool, and JAX's ShardedEnvPool on `default_pool_mesh(1)`
    at the parity contract (Multitask-v0 reads the per-step keys)."""
    name, b = "Multitask-v0", 4
    spool = ShardedEnvPool(name, b, mesh=(CPU,))
    pool = EnvPool(name, b, device=CPU)
    jpool = JShardedEnvPool(name, b, mesh=jax_default_pool_mesh(1))
    outs = []
    for p in (spool, pool, jpool):
        rows = [p.reset(seed=3)]
        for t in range(6):
            a = pool.sample_actions(seed=t)
            if t % 2:
                rows.append(p.step(a if p is not jpool else np.asarray(a),
                                   key=(R.PRNGKey(50 + t, CPU) if p is not
                                        jpool else jax.random.PRNGKey(50 + t))
                                   )[:3])
            else:
                rows.append(p.step(a if p is not jpool else np.asarray(a))[:3])
        outs.append(rows)
    for a, b_ in zip(tree_leaves(outs[0]), tree_leaves(outs[1]), strict=True):
        assert torch.equal(a, b_)
    for want, got in zip(jax.tree.leaves(outs[2]), tree_leaves(outs[0]),
                         strict=True):
        _match(want, got, "sharded vs JAX")
    r1 = spool.rollout(12, R.PRNGKey(4, CPU))
    r2 = pool.rollout(12, R.PRNGKey(4, CPU))
    assert all(torch.equal(x, y) for x, y in zip(r1, r2))
