"""sharding subsystem (port of `repro.sharding`): the logical-axis rules
that say how each LM leaf would be laid over a (pod, data, model) mesh."""
