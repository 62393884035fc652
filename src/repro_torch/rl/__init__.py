"""rl subsystem (port of `repro.rl`): DQN, its networks and replay ring."""
