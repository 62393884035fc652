"""EnvService: session-multiplexing env serving over AsyncEnvPool (port of
`repro.serving.env_service`).

The serving analogue of ServeEngine (serving/engine.py), with env sessions
in place of decode requests: many independent client sessions, each its
own auto-reset episode stream with its own key chain and step budget, are
multiplexed onto ONE batch on the card. The host scheduler is the same
continuous-batching loop:

  submit -> FIFO admission queue (serving/slots.SlotTable, shared with
  ServeEngine) -> a free slot's rows are reset with the session's seed
  (the prefill-into-slot move) -> every tick steps the active lanes
  through the pool's masked step -> budget-exhausted sessions retire and
  free their slot for the next queued session.

Graceful degradation
--------------------
A client that stops answering must not hold a device lane hostage. Per
tick, each session's action round-trip is measured against
`action_timeout_s` (a FaultInjector "stall" fault forces the same path);
a timed-out session backs off its lane for `2**(retries-1)` ticks (the
masked step simply does not move that slot) and after `max_retries`
consecutive timeouts it is EVICTED: its lane rows (env state, auto-reset
key, obs) are copied off the device (`pool.lane_state`), the slot refills
from the queue, and a later `reconnect(sid)` re-queues the session so
`admit_lane` resumes the episode exactly where it stopped.

Service restart: `drain_to_checkpoint(manager)` persists the whole slot
table, every parked (evicted) lane, and the host bookkeeping (session
progress, queue order, slot seating, default-policy RNG states) through
CheckpointManager, with the JAX service's `meta.json`;
`EnvService.restore_service(...)` rebuilds a fresh service from that
checkpoint with every in-flight session resumed in its original slot.
Policies are code, so the caller re-supplies the Session objects and the
checkpoint restores their progress.

Telemetry: per-tick recv latency (p50/p99 via `stats()`), per-session
queue wait and residency (SlotTable), and a runtime/straggler
StragglerTracker over client action latency, so persistently slow
consumers are flagged with the profile/demote advice.

The clock is injectable: the traffic-replay tests drive a scripted clock
so latency accounting, timeouts and injected stalls are deterministic.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch.core.env import Env
from repro_torch.core.spaces import Box, Discrete, MultiDiscrete
from repro_torch.pool.async_pool import AsyncEnvPool, numpy_dtype
from repro_torch.runtime.failures import FaultInjector
from repro_torch.runtime.straggler import StragglerTracker
from repro_torch.serving.slots import SlotTable, percentile


def _np_sample(space, rng: np.random.Generator):
    """Cheap host-side action sampling (the synthetic-client default policy).

    Sessions number in the thousands; per-session device launches for
    action sampling would bench the host RNG, not the pool, so the default
    client uses numpy, drawing what the JAX service's draws. Deterministic
    tests pass explicit `policy=` scripts instead.
    """
    dtype = numpy_dtype(space.dtype)
    if isinstance(space, Discrete):
        return np.asarray(rng.integers(space.n), dtype)
    if isinstance(space, MultiDiscrete):
        return rng.integers(np.zeros_like(np.asarray(space.nvec)),
                            np.asarray(space.nvec)).astype(dtype)
    if isinstance(space, Box):
        lo = np.nan_to_num(np.asarray(space.low, np.float64), neginf=-1.0)
        hi = np.nan_to_num(np.asarray(space.high, np.float64), posinf=1.0)
        return rng.uniform(lo, hi, size=space.shape).astype(dtype)
    raise TypeError(f"no default sampler for space {type(space).__name__}")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass
class Session:
    """One client: seed, step budget, and an optional action policy.

    `policy(obs, t) -> action` is called once per tick while running; None
    means sample uniformly from the action space with a per-session numpy
    generator. Results accumulate in place (the Request.output idiom of
    serving/engine.py).
    """

    sid: int
    seed: int
    num_steps: int
    policy: Optional[Callable] = None
    # -- filled by the service --------------------------------------------
    steps: int = 0
    total_reward: float = 0.0
    episodes: int = 0
    retries: int = 0        # consecutive action timeouts (0 after a success)
    evictions: int = 0
    first_obs: Optional[np.ndarray] = None
    _rng: Optional[np.random.Generator] = None
    _last_obs: Optional[np.ndarray] = None
    _backoff: int = 0       # ticks this lane still idles before a retry

    def action(self, space):
        if self.policy is not None:
            return self.policy(self._last_obs, self.steps)
        if self._rng is None:
            self._rng = np.random.default_rng(self.seed)
        return _np_sample(space, self._rng)


class EnvService:
    """Continuous-batching env server: many sessions, one batch.

    >>> svc = EnvService("CartPole-v1", num_slots=64)
    >>> for i in range(1000):
    ...     svc.submit(Session(sid=i, seed=i, num_steps=100))
    >>> svc.run()            # admit / step / retire until all served
    >>> svc.stats()["recv_p99_s"]

    The slot table lives on `device`, the CUDA card unless the caller
    names another.
    """

    def __init__(self, env: Union[Env, str], num_slots: int, *,
                 backend: str = "auto", tracker: Optional[StragglerTracker] = None,
                 clock: Optional[Callable[[], float]] = None,
                 action_timeout_s: Optional[float] = None,
                 max_retries: int = 3,
                 injector: Optional[FaultInjector] = None, device=None):
        self.pool = AsyncEnvPool(env, num_slots, backend=backend,
                                 device=device)
        self.num_slots = num_slots
        self._clock = clock or time.monotonic
        self.slots = SlotTable(num_slots, clock=self._clock)
        self.tracker = tracker or StragglerTracker()
        self.action_timeout_s = action_timeout_s
        self.max_retries = max_retries
        self.injector = injector
        self._sessions: Dict[int, Session] = {}
        #: sid -> saved lane rows: evicted sessions parked off-device awaiting
        #: reconnect(), plus restored/reconnected sessions queued for a slot —
        #: _admit() resumes these via pool.admit_lane instead of a fresh reset
        self._lanes: Dict[int, Dict[str, Any]] = {}
        self._evicted: set = set()   # parked AND not re-queued yet
        #: sid -> count of fired "stall" faults awaiting a collection attempt
        self._stalled: Dict[int, int] = {}
        self._draining = False
        self.recv_latencies: List[float] = []
        self.ticks = 0
        self.steps_served = 0
        self.timeouts = 0
        self.evictions = 0
        self.eviction_log: Dict[int, str] = {}
        # latest StragglerReport per flagged sid; sessions retire (and the
        # tracker forgets them) before stats() is usually read, so the policy
        # is evaluated every tick and flagged sessions logged here
        self.straggler_log: Dict[int, object] = {}

    # -- client API ----------------------------------------------------------
    def submit(self, session: Session) -> None:
        if session.sid in self._sessions:
            raise ValueError(f"session {session.sid} already submitted")
        if session.num_steps < 1:
            raise ValueError("num_steps budget must be >= 1")
        if self._draining:
            raise RuntimeError("service is draining; not accepting sessions")
        self._sessions[session.sid] = session
        self.slots.submit(session.sid)

    def reconnect(self, sid: int, policy: Optional[Callable] = None) -> None:
        """Re-queue an evicted session; its saved lane resumes the episode.

        The client came back: clear the timeout record (and optionally swap
        the policy), put the sid back in the admission queue. On admission
        the parked lane is spliced into a free slot, so the episode continues
        from the exact step the eviction interrupted.
        """
        if sid not in self._evicted:
            raise ValueError(f"session {sid} is not evicted")
        if self._draining:
            raise RuntimeError("service is draining; not accepting sessions")
        sess = self._sessions[sid]
        sess.retries = 0
        sess._backoff = 0
        if policy is not None:
            sess.policy = policy
        self._evicted.discard(sid)
        self.slots.submit(sid)

    @property
    def queued(self) -> int:
        return self.slots.queued_count

    @property
    def running(self) -> int:
        return self.slots.active_count

    @property
    def evicted(self) -> List[int]:
        """Sids parked off-device awaiting `reconnect()`."""
        return sorted(self._evicted)

    # -- scheduler loop -------------------------------------------------------
    def _admit(self) -> None:
        fresh = []
        for slot, sid in self.slots.admit():
            sess = self._sessions[sid]
            if sid in self._lanes:  # resume a parked lane, not a fresh reset
                _, obs = self.pool.admit_lane(self._lanes.pop(sid), slot=slot)
                self._seat(sess, _host(obs))
            else:
                fresh.append((slot, sess))
        if fresh:  # the tick's fresh sessions in one batched reset
            _, obs = self.pool.admit_many([s.seed for _, s in fresh],
                                          [slot for slot, _ in fresh])
            obs = _host(obs)
            for i, (_, sess) in enumerate(fresh):
                self._seat(sess, obs[i])

    @staticmethod
    def _seat(sess: Session, obs: np.ndarray) -> None:
        obs = obs.copy()  # a row: not the batch it came in
        if sess.first_obs is None:
            sess.first_obs = obs
        sess._last_obs = obs

    def _due_stalls(self) -> Dict[int, int]:
        """Sids whose "stall" fault fired: their NEXT collection attempts
        time out, one per fault. Buffered (counted) rather than tick-scoped
        — faults that fire while a lane is backing off still hit the
        following real attempts, like a client that stays dead."""
        if self.injector is not None:
            for f in self.injector.due(kinds=("stall",)):
                self._stalled[f.arg] = self._stalled.get(f.arg, 0) + 1
        return self._stalled

    def _on_timeout(self, sid: int) -> None:
        """One missed action: back the lane off exponentially; evict after
        `max_retries` consecutive misses."""
        sess = self._sessions[sid]
        sess.retries += 1
        self.timeouts += 1
        if sess.retries > self.max_retries:
            self._evict(sid, f"{sess.retries} consecutive action timeouts")
        else:
            sess._backoff = 2 ** (sess.retries - 1)

    def _evict(self, sid: int, reason: str) -> None:
        """Park a dead client's episode off its slot so the slot can refill."""
        slot = self.slots.slot_of(sid)
        self._lanes[sid] = self.pool.lane_state(slot)
        self.pool.release(slot)
        self.slots.release(sid)
        self.tracker.forget(sid)
        self._stalled.pop(sid, None)
        self._evicted.add(sid)
        sess = self._sessions[sid]
        sess.evictions += 1
        sess._backoff = 0
        self.evictions += 1
        self.eviction_log[sid] = reason

    def tick(self) -> bool:
        """One scheduler tick: admit, collect actions, masked step, retire.

        Returns False when there is nothing to do (drained/idle).
        """
        if not self._draining:
            self._admit()
        running = self.slots.running()
        if not running:
            return False
        self.ticks += 1
        stalled = self._due_stalls()

        acts, slot_ids = [], []
        for sid in running:
            sess = self._sessions[sid]
            if sess._backoff > 0:     # lane idles; masked step skips it
                sess._backoff -= 1
                continue
            if stalled.get(sid):      # injected dead client: no action comes
                self._stalled[sid] -= 1
                if not self._stalled[sid]:
                    del self._stalled[sid]
                self._on_timeout(sid)
                continue
            t0 = self._clock()
            act = np.asarray(sess.action(self.pool.action_space))
            dt = self._clock() - t0
            # the client's action round-trip is the consumer latency the
            # straggler policy watches (slow consumers stall lock-step pools;
            # here they only slow their own lane)
            self.tracker.record(sid, dt)
            if self.action_timeout_s is not None and dt > self.action_timeout_s:
                self._on_timeout(sid)  # stale action discarded
                continue
            sess.retries = 0
            acts.append(act)
            slot_ids.append(self.slots.slot_of(sid))

        if not acts:  # every lane backing off / timed out this tick
            for rep in self.tracker.reports():
                self.straggler_log[rep.host_id] = rep
            return bool(self.slots.active_count or self.slots.queued_count)
        self.pool.send(np.stack(acts), np.asarray(slot_ids))

        t0 = self._clock()
        obs, rew, done, info, out_slots = self.pool.recv()
        self.recv_latencies.append(self._clock() - t0)

        obs_np, rew_np = np.asarray(obs), np.asarray(rew)
        done_np = np.asarray(done)
        for i, slot in enumerate(out_slots):
            sid = self.slots.owner(int(slot))
            sess = self._sessions[sid]
            sess.steps += 1
            self.steps_served += 1
            sess.total_reward += float(rew_np[i])
            sess.episodes += int(done_np[i])
            # a copy: the row is a view of the recv's page-locked pack,
            # which a lane that backs off or is evicted would keep alive
            sess._last_obs = obs_np[i].copy()
            if sess.steps >= sess.num_steps:
                self._retire(int(sid))
        for rep in self.tracker.reports():
            self.straggler_log[rep.host_id] = rep
        return True

    def _retire(self, sid: int) -> None:
        self.pool.release(self.slots.slot_of(sid))
        self.slots.release(sid)
        self.tracker.forget(sid)

    def run(self, max_ticks: int = 100_000) -> int:
        """Serve until every submitted session's budget is spent."""
        ticks = 0
        while (self.slots.queued_count or self.slots.active_count) \
                and ticks < max_ticks:
            self.tick()
            ticks += 1
        return ticks

    def drain(self, max_ticks: int = 100_000) -> int:
        """Graceful drain: stop admitting, finish the running sessions.

        Queued-but-never-admitted sessions stay queued (a later `resume` is
        just `self._draining = False`); running ones run to budget.
        """
        self._draining = True
        ticks = 0
        while self.slots.active_count and ticks < max_ticks:
            self.tick()
            ticks += 1
        return ticks

    # -- checkpointed restart -------------------------------------------------
    def drain_to_checkpoint(self, manager, step: int = 0,
                            blocking: bool = True) -> str:
        """Freeze the service into a checkpoint WITHOUT finishing sessions.

        Stops admission, then persists the whole slot table's carry
        (`pool.state_dict()` — every running lane at its current step),
        every parked lane, and the host bookkeeping as `meta.json`:
        per-session progress, slot seating, queue order, and the default
        policy's numpy RNG state (so even un-scripted clients resume
        bit-exactly). `restore_service` is the other half.
        """
        self._draining = True
        tree = {
            "pool": self.pool.state_dict(),
            "parked": {str(sid): lane for sid, lane in self._lanes.items()},
        }
        sessions: Dict[str, Dict[str, Any]] = {}
        for sid, sess in self._sessions.items():
            if sess.sid not in self.slots and sid not in self._lanes \
                    and sid not in self.slots._queued_ids:
                continue  # retired: nothing in flight to preserve
            status = ("running" if sid in self.slots
                      else "evicted" if sid in self._evicted else "queued")
            sessions[str(sid)] = {
                "seed": sess.seed, "num_steps": sess.num_steps,
                "steps": sess.steps, "total_reward": sess.total_reward,
                "episodes": sess.episodes, "retries": sess.retries,
                "evictions": sess.evictions, "status": status,
                "slot": (self.slots.slot_of(sid)
                         if sid in self.slots else None),
                "rng_state": (sess._rng.bit_generator.state
                              if sess._rng is not None else None),
            }
        meta = {
            "service": {
                "num_slots": self.num_slots,
                "ticks": self.ticks,
                "steps_served": self.steps_served,
                "queue": [rid for rid, _ in self.slots._queue],
                "parked": sorted(self._lanes),
                "sessions": sessions,
            }
        }
        return manager.save(step, tree, blocking=blocking, meta=meta)

    @classmethod
    def restore_service(cls, env: Union[Env, str], num_slots: int,
                        manager, sessions: List[Session], *,
                        step: Optional[int] = None, **kwargs) -> "EnvService":
        """Rebuild a service from `drain_to_checkpoint` with every in-flight
        session resumed: running sessions re-seat in their ORIGINAL slots
        (slot index feeds the per-slot RNG split), queued sessions re-queue
        in order, evicted ones stay parked awaiting `reconnect()`.

        Policies are code and cannot be checkpointed — the caller re-supplies
        the `Session` objects (matched by sid); the checkpoint restores their
        progress, RNG state and lanes. Sessions in the checkpoint but missing
        from `sessions` raise; extra sessions may be `submit()`ed after.
        """
        meta = manager.read_meta(step)
        if not meta or "service" not in meta:
            raise ValueError("checkpoint has no EnvService meta; was it "
                             "written by drain_to_checkpoint()?")
        m = meta["service"]
        if m["num_slots"] != num_slots:
            raise ValueError(f"checkpoint has {m['num_slots']} slots; "
                             f"asked to restore with {num_slots}")
        svc = cls(env, num_slots, **kwargs)
        # templates: a fresh pool snapshot has the right shapes; one lane of
        # it (row 0) templates each parked lane
        pool_tmpl = svc.pool.state_dict()
        lane_tmpl = {"state": tree_map(lambda x: x[0], pool_tmpl["state"]),
                     "obs": pool_tmpl["obs"][0]}
        template = {"pool": pool_tmpl,
                    "parked": {str(k): lane_tmpl for k in m["parked"]}}
        tree = manager.restore(template, step=step)
        svc.pool.load_state_dict(tree["pool"])
        svc._lanes = {int(k): v for k, v in tree["parked"].items()}
        svc.ticks = m["ticks"]
        svc.steps_served = m["steps_served"]

        by_sid = {s.sid: s for s in sessions}
        pool_obs = np.asarray(tree["pool"]["obs"])
        for sid_str, rec in m["sessions"].items():
            sid = int(sid_str)
            if sid not in by_sid:
                raise ValueError(f"checkpoint session {sid} missing from the "
                                 "supplied sessions")
            sess = by_sid[sid]
            sess.steps = rec["steps"]
            sess.total_reward = rec["total_reward"]
            sess.episodes = rec["episodes"]
            sess.retries = rec["retries"]
            sess.evictions = rec["evictions"]
            if rec["rng_state"] is not None:
                sess._rng = np.random.default_rng(sess.seed)
                sess._rng.bit_generator.state = rec["rng_state"]
            svc._sessions[sid] = sess
            if rec["status"] == "running":
                svc.slots.place(sid, rec["slot"])
                sess._last_obs = pool_obs[rec["slot"]].copy()
            elif rec["status"] == "evicted":
                svc._evicted.add(sid)
                sess._last_obs = np.asarray(svc._lanes[sid]["obs"])
        for sid in m["queue"]:  # FIFO order survives the restart
            svc.slots.submit(sid)
        return svc

    # -- telemetry ------------------------------------------------------------
    def stats(self) -> Dict:
        out = dict(self.slots.stats())
        out.update({
            "ticks": self.ticks,
            "steps_served": self.steps_served,
            "recv_p50_s": percentile(self.recv_latencies, 50),
            "recv_p99_s": percentile(self.recv_latencies, 99),
            "timeouts": self.timeouts,
            "evictions": self.evictions,
            "evicted": self.evicted,
            "stragglers": [dataclasses.asdict(r)
                           for r in self.straggler_log.values()],
        })
        return out
