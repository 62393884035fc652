"""Energy & carbon tracking (port of `repro.sustainability.impact`): the
paper's Table II methodology.

The paper uses experiment-impact-tracker (Henderson et al. 2020) to compare
CaiRL vs AI Gym emissions. Without RAPL counters the same accounting runs
on a power-envelope model of the host CPU:

    energy_kwh = Σ_component  utilisation × TDP_watts × hours / 1000
    co2_kg     = energy_kwh × carbon_intensity

CPU utilisation comes from process CPU-time / wall-time (os.times), the same
signal the tracker falls back to. The paper's subtraction trick — "We measure
the emissions by subtracting the DQN time usage with the total time to only
account for the environment run-time costs" — is exposed via
`Impact.minus(other)`. Constants are module-level and documented so results
are auditable. They are the paper's CPU envelope: a run on the card reports
the card's power limit beside them (`nvidia-smi`), since the model charges
no accelerator. `StaticImpact` charges a static time bound (the cost
model's, `repro_torch.analysis.cost`) against a power limit its caller
names: the card's, as `nvidia-smi --query-gpu=power.limit` gives it.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

# Power envelope of the paper's CPU (Intel 8700K, 95 W TDP; the paper's
# machine also held an RTX 2080 Ti).
CPU_TDP_WATTS = 95.0
# World-average grid intensity, kgCO2/kWh (IEA 2021; Henderson et al. default).
CARBON_INTENSITY_KG_PER_KWH = 0.475


@dataclasses.dataclass
class Impact:
    wall_s: float
    cpu_s: float

    @property
    def utilisation(self) -> float:
        return min(self.cpu_s / self.wall_s, float(os.cpu_count() or 1)) if self.wall_s > 0 else 0.0

    @property
    def energy_kwh(self) -> float:
        return self.utilisation * CPU_TDP_WATTS * (self.wall_s / 3600.0) / 1000.0

    @property
    def energy_mwh(self) -> float:
        """Milliwatt-hours, the unit of the paper's Table II."""
        return self.energy_kwh * 1e6

    @property
    def co2_kg(self) -> float:
        return self.energy_kwh * CARBON_INTENSITY_KG_PER_KWH

    def minus(self, other: "Impact") -> "Impact":
        """Paper's subtraction: isolate env cost by removing learner cost."""
        return Impact(max(self.wall_s - other.wall_s, 0.0), max(self.cpu_s - other.cpu_s, 0.0))

    def report(self) -> dict:
        return {
            "wall_s": self.wall_s,
            "cpu_s": self.cpu_s,
            "utilisation": self.utilisation,
            "energy_mWh": self.energy_mwh,
            "co2_kg": self.co2_kg,
        }


@dataclasses.dataclass
class StaticImpact:
    """Table II's analogue from a static time bound instead of a measured
    wall clock (port of `repro.sustainability.impact.StaticImpact`).

    `seconds_per_step` is a roofline bound per env step (the larger of
    compute and memory time, over the env steps of one launch: see
    `repro_torch.analysis.cost`); `watts` the power the bound is charged
    at, which the caller gives: the card's power limit (700 W for an H100
    SXM5 at its maximum). The JAX package defaults it to a TPU envelope;
    here it has no default. Deterministic: the same shapes always give the
    same joules.
    """

    seconds_per_step: float
    watts: float

    @property
    def joules_per_step(self) -> float:
        return self.seconds_per_step * self.watts

    @property
    def joules_per_mstep(self) -> float:
        """Joules per million env steps (the Table II normalisation)."""
        return self.joules_per_step * 1e6

    @property
    def kwh_per_mstep(self) -> float:
        return self.joules_per_mstep / 3.6e6

    @property
    def co2_g_per_mstep(self) -> float:
        return self.kwh_per_mstep * CARBON_INTENSITY_KG_PER_KWH * 1e3

    def report(self) -> dict:
        return {
            "seconds_per_step": self.seconds_per_step,
            "watts": self.watts,
            "joules_per_mstep": self.joules_per_mstep,
            "kwh_per_mstep": self.kwh_per_mstep,
            "co2_g_per_mstep": self.co2_g_per_mstep,
        }


class ImpactTracker:
    """Context manager: `with ImpactTracker() as t: ...; t.impact.report()`."""

    def __init__(self):
        self.impact: Optional[Impact] = None

    def __enter__(self):
        self._wall0 = time.perf_counter()
        t = os.times()
        self._cpu0 = t.user + t.system + t.children_user + t.children_system
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter() - self._wall0
        t = os.times()
        cpu = (t.user + t.system + t.children_user + t.children_system) - self._cpu0
        self.impact = Impact(wall_s=wall, cpu_s=cpu)
        return False


__all__ = ["CARBON_INTENSITY_KG_PER_KWH", "CPU_TDP_WATTS", "Impact",
           "ImpactTracker", "StaticImpact"]
