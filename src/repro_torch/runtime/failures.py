"""Failure detection & recovery orchestration (host-side control plane);
the port's own copy of `repro.runtime.failures` (standard library only).

At 1000+ nodes the control loop is: heartbeat → detect → checkpoint-restore
→ (possibly smaller) mesh → resume from the exact data step. Device code
stays pure; everything here is host logic, unit-testable on CPU with
simulated clocks and injected failures.

`FaultInjector` is the scripted-failure half of that testability story: a
schedule of (time, kind) faults on an injectable clock, consumed by the
layers that simulate each failure mode —

  - "device_loss"  : runtime/supervisor.py raises DeviceLossError from the
                     step path, triggering the elastic recover() flow;
  - "host_death"   : the supervisor stops relaying that host's heartbeats,
                     so HeartbeatMonitor times it out like a real silence;
  - "stall"        : serving/env_service.py treats the named session's next
                     action collection as timed out (a dead/slow client);
  - "preempt_save" : wired to CheckpointManager._pre_replace_hook to kill a
                     write after the tmp dir exists but before the atomic
                     rename — the mid-save preemption window.

The injector only *schedules*; each consumer decides what the fault means,
which keeps the harness reusable across pool, supervisor and service tests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, Optional


@dataclasses.dataclass
class HostStatus:
    host_id: int
    last_heartbeat: float
    last_step: int


class HeartbeatMonitor:
    """Tracks per-host liveness; hosts missing > timeout are declared dead."""

    def __init__(self, num_hosts: int, timeout_s: float = 60.0, clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        now = clock()
        self.hosts: Dict[int, HostStatus] = {
            h: HostStatus(h, now, -1) for h in range(num_hosts)
        }

    def beat(self, host_id: int, step: int) -> None:
        st = self.hosts[host_id]
        st.last_heartbeat = self.clock()
        st.last_step = max(st.last_step, step)

    def dead_hosts(self) -> List[int]:
        now = self.clock()
        return [h for h, st in self.hosts.items() if now - st.last_heartbeat > self.timeout_s]

    def healthy(self) -> bool:
        return not self.dead_hosts()

    def quorum_step(self) -> int:
        """Highest step every live host has definitely passed."""
        live = [st.last_step for h, st in self.hosts.items() if h not in self.dead_hosts()]
        return min(live) if live else -1


class DeviceLossError(RuntimeError):
    """An accelerator (or a host's worth of them) dropped out mid-rollout.

    Raised by the supervisor's step path when a scripted device-loss fault
    fires (on real hardware the analogous signal is a CUDA runtime error);
    the handler is `RolloutSupervisor.recover()` — propose a smaller mesh,
    rebuild the pool, restore the last snapshot.
    """

    def __init__(self, n_lost: int = 1, message: Optional[str] = None):
        self.n_lost = n_lost
        super().__init__(message or f"lost {n_lost} device(s) mid-rollout")


@dataclasses.dataclass
class Fault:
    """One scripted failure: fires once when the clock passes `at`."""

    at: float
    kind: str          # "device_loss" | "host_death" | "stall" | "preempt_save"
    arg: Any = None    # kind-specific payload (n devices, host id, sid, ...)
    fired: bool = False


class FaultInjector:
    """A scripted schedule of faults on an injectable (usually simulated)
    clock. Consumers poll `due()` — each fault is delivered exactly once,
    in schedule order — and apply their own semantics (module docstring).

    >>> clk = [0.0]
    >>> inj = FaultInjector(clock=lambda: clk[0])
    >>> inj.schedule(5.0, "device_loss", 1)
    >>> inj.due()            # nothing yet
    []
    >>> clk[0] = 6.0
    >>> [f.kind for f in inj.due()]
    ['device_loss']
    """

    def __init__(self, faults: Iterable[Fault] = (),
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.faults: List[Fault] = sorted(faults, key=lambda f: f.at)

    def schedule(self, at: float, kind: str, arg: Any = None) -> Fault:
        f = Fault(at, kind, arg)
        self.faults.append(f)
        self.faults.sort(key=lambda x: x.at)
        return f

    def due(self, kinds: Optional[Iterable[str]] = None) -> List[Fault]:
        """Unfired faults whose time has come (marking them fired)."""
        now = self.clock()
        kindset = set(kinds) if kinds is not None else None
        out = []
        for f in self.faults:
            if f.fired or f.at > now:
                continue
            if kindset is not None and f.kind not in kindset:
                continue
            f.fired = True
            out.append(f)
        return out

    def fired(self) -> List[Fault]:
        return [f for f in self.faults if f.fired]

    def pending(self) -> List[Fault]:
        return [f for f in self.faults if not f.fired]


@dataclasses.dataclass
class RecoveryPlan:
    restart_step: int
    surviving_hosts: List[int]
    new_device_count: int
    mesh_shape: tuple
    notes: str


def plan_recovery(monitor: HeartbeatMonitor, devices_per_host: int,
                  checkpoint_step: Optional[int]) -> RecoveryPlan:
    """Derive the restart plan after failures: surviving mesh + restore step."""
    from repro_torch.runtime.elastic import propose_mesh

    dead = set(monitor.dead_hosts())
    surviving = [h for h in monitor.hosts if h not in dead]
    n_dev = len(surviving) * devices_per_host
    shape, axes = propose_mesh(n_dev)
    restart = checkpoint_step if checkpoint_step is not None else 0
    return RecoveryPlan(
        restart_step=restart,
        surviving_hosts=surviving,
        new_device_count=n_dev,
        mesh_shape=shape,
        notes=f"lost hosts {sorted(dead)}; remesh to {shape} {axes}; "
              f"data stream resumes at step {restart} (deterministic pipeline)",
    )
