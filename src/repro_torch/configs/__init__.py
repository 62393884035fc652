"""configs subsystem: the model and shape configurations (copies of
`repro.configs`, without `cairl_dqn`, which waits for the DQN port)."""
