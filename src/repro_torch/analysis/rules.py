"""Rule catalog and pragma grammars of the port's AST lint (port of
`repro.analysis.rules`).

Each rule names one invariant the port depends on. The generic rules keep
the JAX package's names and meaning; the JAX rules about tracing and
donation become their PyTorch hazards: code captured into a CUDA graph, or
run with host syncs raising, and tensors overwritten in place
(`REPLACED`).

Intentional violations are allowlisted in source, in one of two grammars:

    risky_line()   # repro: allow[rule-name] why this is safe here
    risky_line()   # repro_torch: allow[rule-name] why this is safe here

`# repro: allow[...]` is the JAX package's grammar and takes the rules
both catalogs share (`SHARED`): the JAX lint walks the port's sources too
and reports any other name in it. `# repro_torch: allow[...]` takes the
port's own rules (`PORT_ONLY`). A pragma applies to its own line and to
the line below it; several rules are comma-separated.
"""
from __future__ import annotations

import dataclasses
import io
import re
import tokenize
from typing import Dict, Set, Tuple

#: rules whose names and meaning the two catalogs share
SHARED: Dict[str, str] = {
    "key-reuse": (
        "a locally derived PRNG key (repro_torch.random's PRNGKey, split, "
        "fold_in) is consumed by two calls, or used again after being "
        "split: every consumer must get its own split/fold_in"),
    "unguarded-mutation": (
        "shared attribute mutated outside the owning class's lock/condition "
        "in a class that synchronizes with threading primitives"),
    "lock-discipline": (
        "a field that is written under the class's lock/condition elsewhere "
        "is written, or a helper that writes it is called, without holding "
        "the lock; every cross-thread writer of a guarded field must share "
        "the guard"),
    "silent-except": (
        "broad `except Exception` (or bare except) that neither re-raises "
        "nor logs: unexpected errors vanish"),
    "wall-clock": (
        "time.time() used for timing: wall clock can step backwards; use "
        "time.perf_counter() (durations) or time.monotonic() (deadlines)"),
}

#: rules only the port has: the PyTorch hazards of the JAX tracing and
#: donation rules
PORT_ONLY: Dict[str, str] = {
    "host-read-in-capture": (
        "wall-clock, Python random, numpy.random or environment reads inside "
        "a function captured into a CUDA graph (or run with host syncs "
        "raising) in this module: a replay repeats the captured kernels and "
        "never reads the host again"),
    "host-sync-in-capture": (
        ".item(), .tolist(), .cpu(), .numpy() or float()/int()/bool() of a "
        "tensor inside a function captured into a CUDA graph (or run with "
        "host syncs raising): it syncs the host with the card, which a "
        "capture refuses and a step path must not do"),
    "tensor-branch": (
        "Python if/while on a tensor inside a function captured into a CUDA "
        "graph (or run with host syncs raising): the branch syncs, and a "
        "capture freezes the side it took; use torch.where"),
    "read-after-overwrite": (
        "a name bound to a tensor (or a tree of them) that an in-place "
        "writer then overwrites (a `*_` method such as copy_, "
        "Adam.update_, core/carry.py's write_back/write_carry) is read "
        "afterwards as if it held the old value: it holds the new one"),
}

#: the JAX package's rules and the port's rule that takes each one's place
REPLACED: Dict[str, str] = {
    "host-read-in-jit": "host-read-in-capture",
    "tracer-branch": "tensor-branch",
    "use-after-donate": "read-after-overwrite",
    "donation-lifetime": "read-after-overwrite",
}

#: rule id -> one-line description
RULES: Dict[str, str] = {**SHARED, **PORT_ONLY}

#: pragma grammar -> the rules it may name
GRAMMARS: Dict[str, Set[str]] = {"repro": set(SHARED),
                                 "repro_torch": set(PORT_ONLY)}

_PRAGMA_RE = re.compile(
    r"#\s*(repro|repro_torch):\s*allow\[([A-Za-z0-9_,\s\-]+)\]")


@dataclasses.dataclass(frozen=True)
class Violation:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


def pragmas(source: str) -> Dict[int, Set[Tuple[str, str]]]:
    """Line number -> {(grammar, rule id)} allowlisted on that line: a
    pragma on line L covers L and L + 1. Only comments carry pragmas, not
    a pragma quoted in a docstring."""
    out: Dict[int, Set[Tuple[str, str]]] = {}
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        for m in _PRAGMA_RE.finditer(tok.string):
            i = tok.start[0]
            names = {(m.group(1), r.strip()) for r in m.group(2).split(",")
                     if r.strip()}
            out.setdefault(i, set()).update(names)
            out.setdefault(i + 1, set()).update(names)
    return out


def pragma_lines(source: str) -> Dict[int, Set[str]]:
    """Line number -> rule ids a well-formed pragma allowlists there (a
    name in the other grammar's catalog, or in none, allowlists
    nothing)."""
    return {line: {r for g, r in names if r in GRAMMARS[g]}
            for line, names in pragmas(source).items()}


__all__ = ["GRAMMARS", "PORT_ONLY", "REPLACED", "RULES", "SHARED",
           "Violation", "pragma_lines", "pragmas"]
