"""train subsystem (port of `repro.train`).

`repro_torch.train.optim` holds the optimizers, schedules and losses the
learners share. The fused trainer and fleets (`fused`, `fleet`) come with
ROADMAP A10. Exports resolve lazily (PEP 562), as in the JAX package.
"""

__all__ = ["Adam", "AdamState", "SGD", "clip_by_global_norm",
           "cosine_schedule", "global_norm", "huber_loss", "linear_schedule",
           "softmax_cross_entropy"]

_LAZY = {name: ("repro_torch.train.optim", name) for name in __all__}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
