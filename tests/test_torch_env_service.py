"""The port's env service (`repro_torch.serving.EnvService`) against the
JAX package's, on the CPU, on scripted clocks.

  - budgets served, a drain that finishes only the running sessions, the
    straggler flag on a slow client, a scripted session equal to its solo
    lock-step run;
  - injected stalls -> backoff -> eviction (the lane parked off the table)
    -> reconnect, and a slow client timed out by the clock: per-session
    steps, rewards, episodes and evictions, and the service's counters,
    equal to JAX's `EnvService` on the same scripted clock and faults;
  - `drain_to_checkpoint` / `restore_service` against an uninterrupted
    oracle service, the default numpy policy's RNG state included, and a
    JAX-written drain (a parked lane among it) restored into the port.

The JAX side runs inside `jax.threefry_partitionable(False)`. Rewards are
float64 sums of float32 rewards, so equal sums are exact.
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.runtime.failures import FaultInjector as JFaultInjector
from repro.serving.env_service import EnvService as JEnvService
from repro.serving.env_service import Session as JSession
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.spaces import Box, Discrete, MultiDiscrete
from repro_torch.pool import EnvPool
from repro_torch.runtime import FaultInjector
from repro_torch.serving import EnvService, Session
from repro_torch.serving.env_service import _np_sample

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


def _pol(obs, t):
    return np.int32(t % 2)


def _results(svc, sids):
    return ({i: (svc._sessions[i].steps, svc._sessions[i].total_reward,
                 svc._sessions[i].episodes, svc._sessions[i].evictions)
             for i in sids},
            (svc.ticks, svc.steps_served, svc.timeouts, svc.evictions,
             svc.evicted, dict(svc.eviction_log)))


def test_serves_all_budgets():
    svc = EnvService("CartPole-v1", num_slots=4, device=CPU)
    budgets = [8 + (i % 5) for i in range(11)]
    for i, b in enumerate(budgets):
        svc.submit(Session(sid=i, seed=100 + i, num_steps=b))
    svc.run()
    st = svc.stats()
    assert st["released"] == 11 and st["running"] == 0 and st["queued"] == 0
    assert svc.steps_served == sum(budgets)
    for i, b in enumerate(budgets):
        sess = svc._sessions[i]
        assert sess.steps == b and sess.first_obs.shape == (4,)
    assert st["recv_p99_s"] >= st["recv_p50_s"] > 0
    assert svc.pool.backend == "torch"


def test_drain_finishes_running_only():
    svc = EnvService("CartPole-v1", num_slots=4, device=CPU)
    for i in range(8):
        svc.submit(Session(sid=i, seed=i, num_steps=5))
    svc.tick()
    svc.drain()
    st = svc.stats()
    assert st["running"] == 0 and st["queued"] == 4 and st["released"] == 4
    with pytest.raises(RuntimeError, match="draining"):
        svc.submit(Session(sid=99, seed=0, num_steps=3))
    with pytest.raises(ValueError, match="budget"):
        EnvService("CartPole-v1", 1, device=CPU).submit(
            Session(sid=0, seed=0, num_steps=0))


def test_flags_slow_consumer():
    t = [0.0]

    def clock():
        t[0] += 0.001
        return t[0]

    def slow_policy(obs, step):
        t[0] += 0.5
        return np.int32(0)

    svc = EnvService("CartPole-v1", num_slots=4, clock=clock, device=CPU)
    for i in range(4):
        pol = slow_policy if i == 3 else (lambda obs, step: np.int32(0))
        svc.submit(Session(sid=i, seed=i, num_steps=6, policy=pol))
    svc.run()
    flagged = svc.stats()["stragglers"]
    assert [r["host_id"] for r in flagged] == [3]
    assert flagged[0]["advice"] in ("profile", "demote")


def test_session_equals_solo_run():
    """A scripted session served beside others gives its solo lock-step
    run's rewards and episode count."""
    acts = [np.int32((t * 7) % 2) for t in range(40)]
    solo = EnvPool("CartPole-v1", 1, device=CPU)
    solo.reset(seed=42)
    rew, eps = 0.0, 0
    for a in acts:
        _, r, d, _ = solo.step(torch.tensor([a]))
        rew += float(r[0])
        eps += int(d[0])
    svc = EnvService("CartPole-v1", num_slots=2, device=CPU)
    svc.submit(Session(sid=0, seed=42, num_steps=40,
                       policy=lambda obs, step: acts[step]))
    svc.submit(Session(sid=1, seed=5, num_steps=11))
    svc.submit(Session(sid=2, seed=6, num_steps=3))
    svc.run()
    assert (svc._sessions[0].total_reward, svc._sessions[0].episodes) == (
        rew, eps) and eps > 0


def _stall_scenario(Svc, Sess, Inj, device=None):
    clk = [0.0]
    inj = Inj(clock=lambda: clk[0])
    kw = {} if device is None else {"device": device}
    svc = Svc("CartPole-v1", 2, clock=lambda: clk[0], injector=inj,
              max_retries=2, **kw)
    for i in range(3):
        svc.submit(Sess(sid=i, seed=i, num_steps=12, policy=_pol))
    for _ in range(3):
        svc.tick()
    for at in (1.0, 2.0, 3.0):   # 3 misses > max_retries=2 -> eviction
        inj.schedule(at, "stall", 1)
    t = 0
    while 1 not in svc._evicted and t < 40:
        clk[0] += 1.0
        svc.tick()
        t += 1
    mid = _results(svc, range(3))
    svc.run(max_ticks=200)
    svc.reconnect(1)
    svc.run(max_ticks=200)
    return svc, mid, _results(svc, range(3))


def test_stall_backoff_eviction_reconnect_matches_jax():
    """Injected stalls back the lane off, repeated misses evict it (its
    lane parked off the table), reconnect resumes the episode: every
    session's result equals JAX's service on the same clock and faults,
    and the evicted session's equals its undisturbed solo service run."""
    svc, mid, end = _stall_scenario(EnvService, Session, FaultInjector, CPU)
    _, jmid, jend = _stall_scenario(JEnvService, JSession, JFaultInjector)
    assert mid == jmid and end == jend
    assert mid[1][4] == [1] and mid[1][2] == 3 and "timeout" in mid[1][5][1]
    assert all(end[0][i][0] == 12 for i in range(3))
    solo = EnvService("CartPole-v1", 2, device=CPU)
    solo.submit(Session(sid=1, seed=1, num_steps=12, policy=_pol))
    solo.run()
    assert (svc._sessions[1].total_reward, svc._sessions[1].episodes) == (
        solo._sessions[1].total_reward, solo._sessions[1].episodes)


def test_kept_observations_share_no_recv_buffer():
    """A recv's arrays are views of one pack; the rows the service keeps
    (each session's first and last obs, an evicted one's among them) are
    copies, so a parked session holds no recv's buffer alive."""
    clk = [0.0]
    inj = FaultInjector(clock=lambda: clk[0])
    svc = EnvService("CartPole-v1", 2, clock=lambda: clk[0], injector=inj,
                     max_retries=2, device=CPU)
    recvs, recv = [], svc.pool.recv

    def keep(*a, **kw):
        out = recv(*a, **kw)
        recvs.append(out[:3] + tuple(out[3].values()))
        return out

    svc.pool.recv = keep
    for i in range(3):
        svc.submit(Session(sid=i, seed=i, num_steps=12, policy=_pol))
    for at in (1.0, 2.0, 3.0):
        inj.schedule(at, "stall", 1)
    while 1 not in svc._evicted:
        clk[0] += 1.0
        svc.tick()
    assert recvs and svc.evicted == [1]
    kept = [o for s in svc._sessions.values()
            for o in (s._last_obs, s.first_obs) if o is not None]
    assert len(kept) == 4
    assert not any(np.shares_memory(o, x) for o in kept
                   for out in recvs for x in out)


def test_slow_client_times_out_via_clock():
    clk = [0.0]

    def slow_policy(obs, t):
        clk[0] += 2.0            # the client "takes" 2 s to answer
        return np.int32(0)

    svc = EnvService("CartPole-v1", 1, clock=lambda: clk[0],
                     action_timeout_s=1.0, max_retries=1, device=CPU)
    svc.submit(Session(sid=0, seed=0, num_steps=5, policy=slow_policy))
    for _ in range(8):
        svc.tick()
    assert svc.evicted == [0]
    assert svc._sessions[0].steps == 0   # no stale action was applied
    with pytest.raises(ValueError, match="not evicted"):
        svc.reconnect(3)


def test_drain_to_checkpoint_and_restore_matches_oracle(tmp_path):
    """Drain mid-serve, rebuild from the checkpoint, finish: every session
    equals an uninterrupted oracle's (same sessions, slots and order)."""
    clk = [0.0]
    svc = EnvService("CartPole-v1", 2, clock=lambda: clk[0], device=CPU)
    for i in range(4):
        svc.submit(Session(sid=i, seed=i, num_steps=10, policy=_pol))
    for _ in range(4):
        svc.tick()
    mid = {i: svc._sessions[i].steps for i in range(4)}
    assert any(v > 0 for v in mid.values()) and any(v == 0 for v in
                                                     mid.values())
    with CheckpointManager(str(tmp_path)) as mgr:
        svc.drain_to_checkpoint(mgr, step=svc.ticks)
    with pytest.raises(RuntimeError, match="draining"):
        svc.submit(Session(sid=99, seed=9, num_steps=3))
    fresh = [Session(sid=i, seed=i, num_steps=10, policy=_pol)
             for i in range(4)]
    svc2 = EnvService.restore_service("CartPole-v1", 2,
                                      CheckpointManager(str(tmp_path)), fresh,
                                      clock=lambda: clk[0], device=CPU)
    assert {i: svc2._sessions[i].steps for i in range(4)} == mid
    svc2.run(max_ticks=200)
    oracle = EnvService("CartPole-v1", 2, clock=lambda: clk[0], device=CPU)
    for i in range(4):
        oracle.submit(Session(sid=i, seed=i, num_steps=10, policy=_pol))
    oracle.run(max_ticks=200)
    assert _results(svc2, range(4))[0] == _results(oracle, range(4))[0]


def test_restore_preserves_default_policy_rng_and_matches_jax(tmp_path):
    """Un-scripted clients sample from a numpy generator whose bit state is
    checkpointed: random-policy sessions resume exactly, and the numpy
    draws are JAX's service's, so both serve the same results."""
    clk = [0.0]
    svc = EnvService("FrozenLake-v0", 2, clock=lambda: clk[0], device=CPU)
    for i in range(2):
        svc.submit(Session(sid=i, seed=100 + i, num_steps=9))
    for _ in range(5):
        svc.tick()
    with CheckpointManager(str(tmp_path)) as mgr:
        svc.drain_to_checkpoint(mgr, step=5)
    svc2 = EnvService.restore_service(
        "FrozenLake-v0", 2, CheckpointManager(str(tmp_path)),
        [Session(sid=i, seed=100 + i, num_steps=9) for i in range(2)],
        clock=lambda: clk[0], device=CPU)
    svc2.run(max_ticks=100)
    oracle = JEnvService("FrozenLake-v0", 2, clock=lambda: clk[0])
    for i in range(2):
        oracle.submit(JSession(sid=i, seed=100 + i, num_steps=9))
    oracle.run(max_ticks=100)
    assert _results(svc2, range(2))[0] == _results(oracle, range(2))[0]


def test_restore_rejects_missing_sessions_and_bad_slots(tmp_path):
    clk = [0.0]
    svc = EnvService("CartPole-v1", 2, clock=lambda: clk[0], device=CPU)
    svc.submit(Session(sid=0, seed=0, num_steps=5, policy=_pol))
    svc.tick()
    with CheckpointManager(str(tmp_path)) as mgr:
        svc.drain_to_checkpoint(mgr, step=1)
        mgr.save(2, {"x": np.zeros(1)})
    with pytest.raises(ValueError, match="missing"):
        EnvService.restore_service("CartPole-v1", 2,
                                   CheckpointManager(str(tmp_path)), [],
                                   step=1, clock=lambda: clk[0], device=CPU)
    with pytest.raises(ValueError, match="slots"):
        EnvService.restore_service(
            "CartPole-v1", 4, CheckpointManager(str(tmp_path)),
            [Session(sid=0, seed=0, num_steps=5, policy=_pol)], step=1,
            clock=lambda: clk[0], device=CPU)
    with pytest.raises(ValueError, match="no EnvService meta"):
        EnvService.restore_service("CartPole-v1", 2,
                                   CheckpointManager(str(tmp_path)), [],
                                   device=CPU)


def _jax_drained_with_a_parked_lane(d, clk):
    """JAX's service: three sessions over two slots, session 1 stalled
    into eviction (its lane parked), then drained to a checkpoint."""
    inj = JFaultInjector(clock=lambda: clk[0])
    svc = JEnvService("CartPole-v1", 2, clock=lambda: clk[0], injector=inj,
                      max_retries=1)
    for i in range(3):
        svc.submit(JSession(sid=i, seed=i, num_steps=14, policy=_pol))
    for _ in range(3):
        svc.tick()
    for at in (1.0, 2.0):
        inj.schedule(at, "stall", 1)
    while 1 not in svc._evicted:
        clk[0] += 1.0
        svc.tick()
    for _ in range(2):
        svc.tick()
    if d is not None:
        with JCheckpointManager(d) as mgr:
            svc.drain_to_checkpoint(mgr, step=svc.ticks)
    return svc


def test_jax_drain_restores_into_the_port(tmp_path):
    """A JAX service drained with a running, a queued-again and a parked
    session restores into the port's service (the same arrays.npz and
    meta.json); finished, with the parked one reconnected, every session
    equals the JAX service run through without the restart."""
    clk = [0.0]
    _jax_drained_with_a_parked_lane(str(tmp_path), clk)
    sessions = [Session(sid=i, seed=i, num_steps=14, policy=_pol)
                for i in range(3)]
    svc = EnvService.restore_service("CartPole-v1", 2,
                                     CheckpointManager(str(tmp_path)),
                                     sessions, clock=lambda: clk[0],
                                     device=CPU)
    assert svc.evicted == [1] and 1 in svc._lanes
    svc.reconnect(1)
    svc.run(max_ticks=200)
    oracle = _jax_drained_with_a_parked_lane(None, [0.0])
    oracle.reconnect(1)
    oracle.run(max_ticks=200)
    got, want = _results(svc, range(3))[0], _results(oracle, range(3))[0]
    assert got == want and all(v[0] == 14 for v in got.values())


def test_np_sample_draws_the_jax_services_actions():
    """The default client policy's numpy draws, per space type."""
    from repro.core.spaces import Box as JBox
    from repro.core.spaces import Discrete as JDiscrete
    from repro.core.spaces import MultiDiscrete as JMultiDiscrete
    from repro.serving.env_service import _np_sample as jax_np_sample

    pairs = ((Discrete(5), JDiscrete(5)),
             (MultiDiscrete((3, 4)), JMultiDiscrete((3, 4))),
             (Box(-2.0, 2.0, (1,)), JBox(-2.0, 2.0, (1,))),
             (Box(-np.inf, np.inf, (2,)), JBox(-np.inf, np.inf, (2,))))
    for space, jspace in pairs:
        a, b = np.random.default_rng(3), np.random.default_rng(3)
        for _ in range(5):
            x, y = _np_sample(space, a), jax_np_sample(jspace, b)
            assert x.dtype == y.dtype and np.array_equal(x, y), space
