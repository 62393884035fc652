"""data subsystem (port of `repro.data`): the deterministic synthetic
token stream that `launch/train.py` trains on."""
