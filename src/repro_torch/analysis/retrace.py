"""Retrace guard: turn silent re-captures into loud errors (port of
`repro.analysis.retrace`).

`jax.jit` retraces on every new (shape, dtype, static-arg) signature. The
port's counterpart of a trace is a captured CUDA graph or a built kernel:
a call site owns one per distinct (shape, dtype, device) signature of its
tensor arguments, and a new signature on a step path means a new capture
(seconds) or a graph replayed on the wrong shapes. `RetraceGuard(fn,
budget)` counts the signatures a call site has seen and raises
`RetraceError` at the first call past its budget, before it runs.

`trace_count(fn)` is the number of captures a fused runner holds
(`train/fused.py::fused_train_chunk`'s unit: 0 before its first chunk on
the card, 1 after; a chunk of any length replays the one graph), or the
signatures a guard has seen; None on a foreign callable.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Set, Tuple

import torch
from torch.utils._pytree import tree_leaves


class RetraceError(RuntimeError):
    """A guarded call site exceeded its capture budget."""

    def __init__(self, name: str, budget: int, traces: int):
        self.name = name
        self.budget = budget
        self.traces = traces
        super().__init__(
            f"{name}: {traces} distinct (shape, dtype, device) signatures "
            f"exceed the budget of {budget}: a call-site signature is "
            "unstable (a shape or dtype leak), and each new one is another "
            "capture or kernel build. Stabilize the inputs or raise the "
            "budget explicitly if the extra specialization is intentional.")


def signature(args: tuple, kwargs: dict) -> Tuple:
    """(shape, dtype, device) of every tensor leaf of a call's arguments,
    in order: what a capture or a kernel build is specialized on."""
    return tuple((tuple(x.shape), x.dtype, x.device)
                 for x in tree_leaves((args, kwargs))
                 if isinstance(x, torch.Tensor))


def trace_count(fn: Any) -> Optional[int]:
    """Captures a fused runner (`fused_train_chunk`'s `run_chunk`) holds,
    or signatures a `RetraceGuard` has seen; None on foreign callables."""
    if isinstance(fn, RetraceGuard):
        return fn.traces
    stats = getattr(fn, "stats", None)
    if isinstance(stats, dict) and "capture" in stats:
        return int(stats["capture"] is not None)
    return None


class RetraceGuard:
    """Wrap a step callable and enforce a budget of signatures per call
    site.

    >>> step = RetraceGuard(pool_step, budget=1, name="envpool.step")
    >>> step(carry, actions)          # first signature: ok
    >>> step(carry, actions)          # seen: ok
    >>> step(bad_shaped, actions)     # RetraceError, before it runs
    """

    def __init__(self, fn: Callable[..., Any], budget: int = 1,
                 name: Optional[str] = None):
        if not callable(fn):
            raise TypeError(f"RetraceGuard needs a callable; got {fn!r}")
        self._fn = fn
        self.budget = int(budget)
        self.name = name or getattr(fn, "__name__", repr(fn))
        self._seen: Set[Tuple] = set()
        functools.update_wrapper(self, fn, updated=())

    @property
    def traces(self) -> int:
        return len(self._seen)

    def check(self) -> int:
        """Raise RetraceError if over budget; return the signature count."""
        if self.traces > self.budget:
            raise RetraceError(self.name, self.budget, self.traces)
        return self.traces

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        sig = signature(args, kwargs)
        if sig not in self._seen:
            if len(self._seen) >= self.budget:
                raise RetraceError(self.name, self.budget,
                                   len(self._seen) + 1)
            self._seen.add(sig)
        return self._fn(*args, **kwargs)


__all__ = ["RetraceError", "RetraceGuard", "signature", "trace_count"]
