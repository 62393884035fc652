"""checkpoint subsystem (port of `repro.checkpoint`)."""
