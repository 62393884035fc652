"""RolloutSupervisor: fault-tolerant elastic rollouts over any pool (port of
`repro.runtime.supervisor`).

The supervisor wraps a pool (EnvPool, ShardedEnvPool, AsyncEnvPool) and
makes its stateful rollout survivable without touching the step path:

  step/recv --> fault poll --> pool step (the megastep path, unchanged)
                                   |
                        every `snapshot_every` steps
                                   v
                   pool.state_dict() + step counter --> CheckpointManager
                   (device -> host gather at the        (atomic write, off
                    step boundary)                       the thread, keep-k)

On device loss (a scripted FaultInjector "device_loss" fault here; a CUDA
runtime error on real hardware) the step path raises `DeviceLossError` and
the rollout loop calls `recover()`: size the surviving mesh
(`propose_mesh`), rebuild the pool on it, restore the latest snapshot.
The rollout then resumes from the snapshot's step counter bit for bit:
the snapshot holds the env state, the auto-reset keys, the carry key, the
obs and, for async pools, the active mask and both host key chains, so
replaying the deterministic action and key stream from `supervisor.t`
reproduces the uninterrupted trajectory.

Heartbeats: with a `HeartbeatMonitor` attached, every step relays beats for
the live hosts of the simulated fleet; a scripted "host_death" fault stops
one host's beats, the monitor times it out like a real silence, and
`plan_recovery` sizes the surviving mesh.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.runtime.elastic import (build_mesh, propose_mesh,
                                         visible_devices)
from repro_torch.runtime.failures import (DeviceLossError, FaultInjector,
                                          HeartbeatMonitor, plan_recovery)


class RolloutSupervisor:
    """Wrap a pool so its rollout survives kills, preemptions and re-meshes.

    >>> pool = ShardedEnvPool("CartPole-v1", 256, mesh=mesh)
    >>> sup = RolloutSupervisor(pool, "/ckpt/run0", snapshot_every=64)
    >>> sup.reset(seed=0)
    >>> while t < total:
    ...     try:
    ...         obs, rew, done, info = sup.step(actions[t]); t += 1
    ...     except DeviceLossError:
    ...         sup.recover()          # smaller mesh + restore
    ...         t = sup.t              # replay the deterministic stream

    The wrapped pool's surface stays reachable (attribute passthrough);
    `step`/`send`/`recv` are intercepted for fault polling, heartbeats and
    the snapshot cadence. Snapshots are asynchronous by default: the
    device -> host gather runs at the step boundary, the file write
    off-thread (CheckpointManager serializes and joins them).
    """

    def __init__(self, pool, manager, *, snapshot_every: int = 64,
                 blocking_snapshots: bool = False,
                 monitor: Optional[HeartbeatMonitor] = None,
                 injector: Optional[FaultInjector] = None,
                 devices_per_host: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.pool = pool
        self.manager = (manager if isinstance(manager, CheckpointManager)
                        else CheckpointManager(manager))
        self.snapshot_every = int(snapshot_every)
        self.blocking_snapshots = blocking_snapshots
        self.monitor = monitor
        self.injector = injector
        self.devices_per_host = devices_per_host
        self.clock = clock
        #: steps served since reset(): the data-stream position, restored
        #: from the snapshot, where the rollout loop resumes its replay
        self.t = 0
        self.snapshots = 0
        self.recoveries = 0
        self._dead_hosts: set = set()

    # -- pool passthrough ------------------------------------------------------
    def __getattr__(self, name):
        return getattr(self.pool, name)

    def __len__(self) -> int:
        return len(self.pool)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"RolloutSupervisor({self.pool!r}, t={self.t}, "
                f"snapshots={self.snapshots}, recoveries={self.recoveries})")

    # -- supervised stateful surface ------------------------------------------
    def reset(self, seed: int = 0):
        obs = self.pool.reset(seed=seed)
        self.t = 0
        self._beat()
        return obs

    def step(self, actions, key=None):
        """One supervised pool step: poll faults, step, beat, maybe snapshot."""
        self.poll_faults()
        out = (self.pool.step(actions) if key is None
               else self.pool.step(actions, key=key))
        self._after_step()
        return out

    # async-pool surface: send stages (faults polled), recv is the step tick
    def send(self, actions, ids) -> None:
        self.poll_faults()
        self.pool.send(actions, ids)

    def recv(self, **kwargs):
        out = self.pool.recv(**kwargs)
        self._after_step()
        return out

    def _after_step(self) -> None:
        self.t += 1
        self._beat()
        if self.snapshot_every and self.t % self.snapshot_every == 0:
            self.snapshot()

    # -- heartbeats / faults ---------------------------------------------------
    def _beat(self) -> None:
        """Relay beats for the simulated fleet's live hosts."""
        if self.monitor is None:
            return
        for h in self.monitor.hosts:
            if h not in self._dead_hosts:
                self.monitor.beat(h, self.t)

    def poll_faults(self) -> None:
        """Consume due scripted faults. "host_death" silences that host's
        beats (the monitor then times it out); "device_loss" raises out of
        the step path, and the rollout loop handles it with `recover()`."""
        if self.injector is None:
            return
        for f in self.injector.due(kinds=("host_death", "device_loss")):
            if f.kind == "host_death":
                self._dead_hosts.add(f.arg if f.arg is not None else 0)
            elif f.kind == "device_loss":
                raise DeviceLossError(int(f.arg) if f.arg is not None else 1)

    # -- snapshot / restore ----------------------------------------------------
    def snapshot(self, blocking: Optional[bool] = None) -> str:
        """Persist the pool carry + step counter as checkpoint step `t`."""
        tree = dict(self.pool.state_dict())
        assert "t" not in tree
        tree["t"] = np.asarray(self.t, np.int64)
        blocking = (self.blocking_snapshots if blocking is None else blocking)
        path = self.manager.save(self.t, tree, blocking=blocking)
        self.snapshots += 1
        return path

    def restore(self, step: Optional[int] = None, pool=None) -> int:
        """Restore a snapshot (latest by default) into `pool` (default: the
        current one); returns the restored step counter."""
        if pool is not None:
            self.pool = pool
        self.manager.wait()  # an in-flight write may BE the target snapshot
        if not self.pool.has_carry:
            self.pool.reset(seed=0)  # template structure only; overwritten
        template = dict(self.pool.state_dict())
        template["t"] = np.asarray(0, np.int64)
        tree = self.manager.restore(template, step=step)
        self.t = int(np.asarray(tree.pop("t")))
        self.pool.load_state_dict(tree)
        self._beat()
        return self.t

    # -- elastic recovery ------------------------------------------------------
    def recover(self, n_devices: Optional[int] = None,
                rebuild: Optional[Callable] = None,
                step: Optional[int] = None) -> Dict[str, Any]:
        """Device-loss recovery: size the surviving mesh, rebuild the pool on
        it, restore the latest snapshot.

        `n_devices` defaults to the monitor's surviving hosts ×
        devices_per_host (every visible device of the pool's type without a
        monitor: `torch.cuda.device_count()`, or 1 on the CPU), clamped to
        the visible devices. `rebuild(mesh) -> pool` builds the
        replacement; the default re-meshes a ShardedEnvPool and rebuilds an
        EnvPool or AsyncEnvPool like for like on the mesh's first device.
        Returns a record of the plan (mesh shape, restored step, ...).
        """
        self.manager.wait()
        device_type = self.pool.device.type
        visible = visible_devices(device_type)
        plan_notes = ""
        if n_devices is None:
            if self.monitor is not None:
                plan = plan_recovery(self.monitor, self.devices_per_host,
                                     self.manager.latest_step())
                n_devices, plan_notes = plan.new_device_count, plan.notes
            else:
                n_devices = visible
        # a simulated fleet can claim more hosts than this process has
        # devices; the mesh is built from what it sees
        n_devices = max(1, min(int(n_devices), visible))
        # env pools are pure data-parallel: no model axis to preserve
        shape, axes = propose_mesh(n_devices, prefer_model=1)
        mesh = build_mesh(n_devices, device_type=device_type)
        new_pool = (rebuild or self._default_rebuild)(mesh)
        t = self.restore(step=step, pool=new_pool)
        self.recoveries += 1
        return {"mesh_shape": shape, "mesh_axes": axes,
                "n_devices": n_devices, "restored_step": t,
                "mesh": [str(d) for d in mesh], "notes": plan_notes}

    def _default_rebuild(self, mesh):
        from repro_torch.pool import AsyncEnvPool, EnvPool, ShardedEnvPool

        p = self.pool
        if isinstance(p, ShardedEnvPool):
            return ShardedEnvPool(p.env, p.num_envs, mesh=mesh,
                                  backend=p.backend, unroll=p.unroll)
        if isinstance(p, AsyncEnvPool):
            return AsyncEnvPool(p.env, p.num_slots, backend=p.backend,
                                device=mesh[0])
        if isinstance(p, EnvPool):
            return EnvPool(p.env, p.num_envs, backend=p.backend,
                           unroll=p.unroll, device=mesh[0])
        raise TypeError(f"no default rebuild for {type(p).__name__}; "
                        "pass rebuild=")

    def close(self) -> None:
        """Join pending snapshot writes (and refuse further saves)."""
        self.manager.close()


__all__ = ["RolloutSupervisor"]
