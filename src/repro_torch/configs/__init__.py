"""configs subsystem: the model and shape configurations and the paper's
DQN configuration (copies of `repro.configs`, without `input_specs`)."""
