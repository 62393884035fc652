"""train subsystem (port of `repro.train`).

`repro_torch.train.fused` is the fused trainer: train steps captured into
CUDA graphs and replayed with the carry updated in place, and seeds × lr
fleets (`fleet`); `lower_train_chunk` captures, without replaying, the
graph a fused run replays, for the audit (`repro_torch.analysis.audit`). `repro_torch.train.optim` holds the optimizers,
schedules and losses the learners share; `trainer` is the LM train step
and `compression` its int8 gradient round trip. Exports resolve lazily
(PEP 562), as in the JAX package.
"""

#: public surface: the JAX package's `repro.train`
__all__ = ["Fleet", "GOLDEN_TRAIN_IDS", "fleet", "fleet_grid",
           "fused_train_chunk", "golden_train_setup", "lower_train_chunk",
           "run_fused"]

_LAZY = {name: ("repro_torch.train.fused", name) for name in __all__}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
