"""sustainability subsystem (port of `repro.sustainability`): Table II's
energy and carbon accounting."""
