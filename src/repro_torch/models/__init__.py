"""models subsystem: the LM stack (port of `repro.models`: the dense GQA
blocks so far)."""
