"""launch subsystem: command-line entry points (serve.py so far)."""
