"""runtime subsystem (port of `repro.runtime`): straggler telemetry. The
elastic mesh, failure detection and supervised rollouts come with ROADMAP
A12."""
from repro_torch.runtime.straggler import StragglerReport, StragglerTracker

__all__ = ["StragglerReport", "StragglerTracker"]
