"""repro_torch.analysis: the port's static-analysis gates (port of
`repro.analysis`).

  - `repro_torch.analysis.lint`   : AST lint of the port's invariants (key
    reuse, host reads, syncs and tensor branches in code captured into a
    CUDA graph, reads of tensors overwritten in place, unguarded shared
    state, silent excepts, wall-clock timing), with pragmas in two
    grammars (`rules.py`).
  - `repro_torch.analysis.audit`  : one step of every registry id × step
    path watched on the card: no host sync, no host copy past its budget,
    the carry written in place, launches independent of the ready set;
    and the fused train units' graphs free of host nodes.
  - `repro_torch.analysis.retrace`: `RetraceGuard`, a budget of captures
    (or kernel builds) per call site.
  - `repro_torch.analysis.cost`   : the static cost model (each kernel's
    `cost`, the aten ops' flops and bytes, the H100 roofline, StaticImpact)
    and its regression check.

    python -m repro_torch.analysis.lint src/repro_torch
    python -m repro_torch.analysis.audit --smoke --json PATH [--device cpu]
    python -m repro_torch.analysis.cost --smoke [--device cpu]
"""
__all__ = [
    "RULES",
    "RetraceError",
    "RetraceGuard",
    "Violation",
    "lint_paths",
    "lint_source",
]

# lazy (PEP 562), so `python -m repro_torch.analysis.lint` does not import
# the submodule twice and the package imports nothing for RULES alone
_EXPORTS = {
    "RULES": "repro_torch.analysis.rules",
    "Violation": "repro_torch.analysis.rules",
    "lint_paths": "repro_torch.analysis.lint",
    "lint_source": "repro_torch.analysis.lint",
    "RetraceError": "repro_torch.analysis.retrace",
    "RetraceGuard": "repro_torch.analysis.retrace",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
