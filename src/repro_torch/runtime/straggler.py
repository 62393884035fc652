"""Straggler detection & mitigation (host-side telemetry); the port's own
copy of `repro.runtime.straggler` (standard library only).

SPMD training runs at the speed of the slowest participant, so persistent
stragglers are as costly as failures. Policy implemented here:
  1. per-host step-time EWMA; hosts persistently > `threshold`× the fleet
     median are flagged;
  2. flagged hosts get `advice`: first "profile" (transient), then "demote"
     (evict and re-mesh, cheaper than dragging the fleet — the same
     restore path as a failure, planned not reactive:
     runtime/supervisor.py's `recover()`).
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List


@dataclasses.dataclass
class StragglerReport:
    host_id: int
    ewma_s: float
    median_s: float
    ratio: float
    advice: str


class StragglerTracker:
    """Participants are hosts for SPMD training, or the lanes of a
    `pool.HostPool`; serving/env_service.py reuses the same policy over
    *client sessions* —
    a session whose action round-trip is persistently slower than the fleet
    median is the slow consumer the async pool exists to isolate, and gets
    the same profile->demote advice. Sessions come and go, so ids register
    lazily on first `record` (num_hosts=0) and `forget` drops departed ones.
    """

    def __init__(self, num_hosts: int = 0, threshold: float = 1.5,
                 alpha: float = 0.2, patience: int = 3):
        self.threshold = threshold
        self.alpha = alpha
        self.patience = patience
        self.ewma: Dict[int, float] = {h: 0.0 for h in range(num_hosts)}
        self.strikes: Dict[int, int] = {h: 0 for h in range(num_hosts)}

    def record(self, host_id: int, step_time_s: float) -> None:
        prev = self.ewma.setdefault(host_id, 0.0)
        self.strikes.setdefault(host_id, 0)
        self.ewma[host_id] = step_time_s if prev == 0.0 else (
            self.alpha * step_time_s + (1 - self.alpha) * prev
        )

    def reports(self) -> List[StragglerReport]:
        vals = [v for v in self.ewma.values() if v > 0]
        if not vals:
            return []
        med = statistics.median(vals)
        out = []
        for h, v in self.ewma.items():
            if v <= 0:
                continue
            ratio = v / med if med > 0 else 1.0
            if ratio > self.threshold:
                self.strikes[h] += 1
            else:
                self.strikes[h] = 0
            advice = "ok"
            if self.strikes[h] >= self.patience:
                advice = "demote"
            elif self.strikes[h] > 0:
                advice = "profile"
            if advice != "ok":
                out.append(StragglerReport(h, v, med, ratio, advice))
        return out

    def forget(self, host_id: int) -> None:
        """Drop a departed participant (a released session) from the fleet."""
        self.ewma.pop(host_id, None)
        self.strikes.pop(host_id, None)

    def hosts_to_demote(self) -> List[int]:
        return [r.host_id for r in self.reports() if r.advice == "demote"]
