"""launch subsystem: command-line entry points (serve.py, train.py)."""
