"""runtime subsystem (port of `repro.runtime`): elasticity, failure
detection, supervised rollouts and straggler telemetry. `reshard_state`,
which places LM parameters by the sharding rules, comes with those rules
(ROADMAP A14)."""
from repro_torch.runtime.elastic import build_mesh, propose_mesh
from repro_torch.runtime.failures import (DeviceLossError, Fault,
                                          FaultInjector, HeartbeatMonitor,
                                          HostStatus, RecoveryPlan,
                                          plan_recovery)
from repro_torch.runtime.straggler import StragglerReport, StragglerTracker
from repro_torch.runtime.supervisor import RolloutSupervisor

__all__ = [
    "build_mesh", "propose_mesh",
    "DeviceLossError", "Fault", "FaultInjector", "HeartbeatMonitor",
    "HostStatus", "RecoveryPlan", "plan_recovery",
    "StragglerReport", "StragglerTracker", "RolloutSupervisor",
]
