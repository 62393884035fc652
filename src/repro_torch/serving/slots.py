"""Slot bookkeeping shared by the continuous-batching engines (a copy of
`repro.serving.slots`, which imports no JAX).

ServeEngine (serving/engine.py) and, in the JAX package, EnvService
run the same host-side pattern: a fixed number of device-resident slots,
a FIFO admission queue, and continuous refill — when an occupant finishes,
its slot is freed and the next queued request is prefilled / reset into
the same rows. The bookkeeping used to live inline in ServeEngine
(`_slot_req` + `_free_slots`, untested), and the latency accounting only
in the env service; `SlotTable` is the single shared copy of both.

Accounting: the table records, per occupant, the queue wait (submit ->
admit) and the slot residency (admit -> release). The clock is injectable
so tests drive a scripted one (tests/test_slots.py) — the same
deterministic-clock idea the traffic-replay harness uses.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple


def percentile(values, q: float) -> float:
    """Nearest-rank percentile without a numpy dependency on the hot path."""
    if not values:
        return float("nan")
    xs = sorted(values)
    rank = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return float(xs[rank])


class SlotTable:
    """FIFO admission queue + slot ownership map + wait/residency accounting.

    Ids are opaque (request rids, session sids). Invariants (property-tested
    in tests/test_property.py):

      - a slot has at most one owner, an id at most one slot;
      - `admit()` never leaves a slot free while the queue is non-empty;
      - admission is FIFO over ids, filling the lowest free slots first
        (the ServeEngine ordering, now pinned by tests).
    """

    def __init__(self, num_slots: int, clock: Optional[Callable[[], float]] = None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = int(num_slots)
        self._clock = clock or time.monotonic
        self._owner: List[Optional[Any]] = [None] * self.num_slots
        self._slot_of: Dict[Any, int] = {}
        self._queue: Deque[Tuple[Any, float]] = deque()
        self._queued_ids: set = set()
        self._admitted_at: Dict[Any, float] = {}
        self.queue_waits: List[float] = []
        self.residencies: List[float] = []
        self.admitted = 0
        self.released = 0

    # -- queries ---------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._owner) if r is None]

    def owner(self, slot: int) -> Optional[Any]:
        return self._owner[slot]

    def slot_of(self, rid) -> int:
        return self._slot_of[rid]

    def running(self) -> List[Any]:
        """Occupant ids in slot order."""
        return [r for r in self._owner if r is not None]

    @property
    def active_count(self) -> int:
        return len(self._slot_of)

    @property
    def queued_count(self) -> int:
        return len(self._queue)

    def __contains__(self, rid) -> bool:
        return rid in self._slot_of

    # -- lifecycle -------------------------------------------------------
    def submit(self, rid) -> None:
        """Queue an id for admission (FIFO)."""
        if rid in self._queued_ids or rid in self._slot_of:
            raise ValueError(f"id {rid!r} already queued or running")
        self._queue.append((rid, self._clock()))
        self._queued_ids.add(rid)

    def admit(self) -> List[Tuple[int, Any]]:
        """Fill free slots from the queue head: [(slot, rid), ...].

        Queue order is preserved; the earliest queued id takes the lowest
        free slot (exactly the ServeEngine `_admit` loop ordering).
        """
        out = []
        now = self._clock()
        for slot in self.free_slots():
            if not self._queue:
                break
            rid, t_submit = self._queue.popleft()
            self._queued_ids.discard(rid)
            self._owner[slot] = rid
            self._slot_of[rid] = slot
            self._admitted_at[rid] = now
            self.queue_waits.append(now - t_submit)
            self.admitted += 1
            out.append((slot, rid))
        return out

    def place(self, rid, slot: int) -> None:
        """Seat `rid` directly in `slot`, bypassing the queue.

        The service-restart path (EnvService.restore_service) uses this to
        re-seat checkpointed sessions in their ORIGINAL slots — slot index
        feeds the per-slot RNG split, so keeping it is part of resuming
        key-dependent envs bit-exactly. Not for normal admission: `admit()`
        owns the FIFO/lowest-slot ordering.
        """
        if rid in self._queued_ids or rid in self._slot_of:
            raise ValueError(f"id {rid!r} already queued or running")
        if self._owner[slot] is not None:
            raise ValueError(
                f"slot {slot} already owned by {self._owner[slot]!r}")
        self._owner[slot] = rid
        self._slot_of[rid] = slot
        self._admitted_at[rid] = self._clock()
        self.admitted += 1

    def release(self, rid) -> int:
        """Free the slot owned by `rid`; returns the slot index."""
        slot = self._slot_of.pop(rid)
        self._owner[slot] = None
        self.residencies.append(self._clock() - self._admitted_at.pop(rid))
        self.released += 1
        return slot

    # -- accounting ------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        return {
            "admitted": self.admitted,
            "released": self.released,
            "running": self.active_count,
            "queued": self.queued_count,
            "queue_wait_p50": percentile(self.queue_waits, 50),
            "queue_wait_p99": percentile(self.queue_waits, 99),
            "residency_p50": percentile(self.residencies, 50),
            "residency_p99": percentile(self.residencies, 99),
        }

    def __repr__(self) -> str:  # pragma: no cover
        return (f"SlotTable({self.active_count}/{self.num_slots} running, "
                f"{self.queued_count} queued)")
