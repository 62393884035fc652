"""runtime subsystem (port of `repro.runtime`): elasticity, failure
detection, supervised rollouts and straggler telemetry."""
from repro_torch.runtime.elastic import build_mesh, propose_mesh, reshard_state
from repro_torch.runtime.failures import (DeviceLossError, Fault,
                                          FaultInjector, HeartbeatMonitor,
                                          HostStatus, RecoveryPlan,
                                          plan_recovery)
from repro_torch.runtime.straggler import StragglerReport, StragglerTracker
from repro_torch.runtime.supervisor import RolloutSupervisor

__all__ = [
    "build_mesh", "propose_mesh", "reshard_state",
    "DeviceLossError", "Fault", "FaultInjector", "HeartbeatMonitor",
    "HostStatus", "RecoveryPlan", "plan_recovery",
    "StragglerReport", "StragglerTracker", "RolloutSupervisor",
]
