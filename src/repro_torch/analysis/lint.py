"""AST lint of the port's invariants over a source tree (port of
`repro.analysis.lint`): `python -m repro_torch.analysis.lint src/repro_torch`.

One module is analyzed at a time; all reasoning is module-local and
heuristic by design, as in the JAX lint, with no imports of the linted
code. Per module the linter builds:
  - an import-alias table, so `R.split`, `repro_torch.random.split` and
    `from repro_torch.random import split` all canonicalize alike;
  - the set of *capture roots*: functions called inside a
    `with torch.cuda.graph(...):` block, functions passed to the fused
    trainer (`fused_train_chunk`, `run_fused`, `_GraphRunner`) or to
    `torch.cuda.make_graphed_callables`, and functions called between
    `torch.cuda.set_sync_debug_mode("error")` and the mode's reset in one
    function body: the port's counterpart of the JAX lint's jit roots;
  - a name-level call graph walked from the roots to the set of
    *capture-reachable* functions, the scope of the host-read, host-sync
    and tensor-branch rules.

The rules are `repro_torch.analysis.rules.RULES`; intentional sites carry a
pragma (same line or the line above) in the grammar of their rule:
`# repro: allow[...]` for the rules the JAX catalog shares,
`# repro_torch: allow[...]` for the port's own.
"""
from __future__ import annotations

import argparse
import ast
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.rules import (GRAMMARS, RULES, SHARED, Violation,
                                        pragmas)

# attribute reads that are host values (safe in a Python branch)
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "itemsize", "device",
                 "is_cuda", "requires_grad", "layout"}

# canonical producers of tensors, less those that return host values
_TENSOR_PREFIXES = ("torch.",)
_NON_TENSOR_PREFIXES = ("torch.is_", "torch.cuda.", "torch.backends.",
                        "torch.jit.", "torch.get_", "torch.are_",
                        "torch.device", "torch.dtype", "torch.Size",
                        "torch.finfo", "torch.iinfo", "torch.profiler.",
                        "torch.autograd.", "torch.utils.", "torch.no_grad",
                        "torch.enable_grad", "torch.inference_mode",
                        "torch.Generator", "torch.compiler.")

# canonical producers of PRNG keys (assignment RHS types a name as a key)
_KEY_PRODUCERS = {"repro_torch.random.PRNGKey", "repro_torch.random.split",
                  "repro_torch.random.fold_in"}

# canonical calls that read host state a replay would not read again
_HOST_READS = {"time.time", "time.time_ns", "time.monotonic",
               "time.monotonic_ns", "time.perf_counter",
               "time.perf_counter_ns", "time.process_time", "os.getenv",
               "os.environ.get", "datetime.datetime.now",
               "datetime.datetime.utcnow", "open", "input"}
_HOST_READ_PREFIXES = ("random.", "numpy.random.")

# host syncs: tensor methods, and casts of a tensor to a Python scalar
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SYNC_CASTS = {"float", "int", "bool"}

# callables whose function argument is captured into a CUDA graph
_CAPTURERS = {"fused_train_chunk", "run_fused", "_GraphRunner",
              "torch.cuda.make_graphed_callables",
              "repro_torch.train.fused.fused_train_chunk",
              "repro_torch.train.fused.run_fused"}

# in-place writers that are functions: name -> the argument positions they
# overwrite (core/carry.py; a method call `x.f_(...)` overwrites x)
_OVERWRITERS = {"write_back": (0,), "write_carry": (0,)}
# method writers that overwrite arguments: Adam.update_(grads, state,
# params) writes state and params
_METHOD_OVERWRITES = {"update_": (1, 2)}

_LOCK_FACTORIES = {"threading.Lock", "threading.RLock", "threading.Condition",
                   "threading.Semaphore", "threading.BoundedSemaphore"}

_LOG_MARKERS = ("print", "warn", "log", "record", "report")


def _dotted(node: ast.AST) -> Optional[str]:
    """`a.b.c` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Imports:
    """Alias table: first path component rewritten to its imported target."""

    def __init__(self, tree: ast.Module):
        self.table: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.table[(a.asname or a.name.split(".")[0])] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.table[a.asname or a.name] = f"{node.module}.{a.name}"

    def canon(self, dotted: Optional[str]) -> Optional[str]:
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        head = self.table.get(head, head)
        return f"{head}.{rest}" if rest else head

    def canon_call(self, call: ast.Call) -> Optional[str]:
        return self.canon(_dotted(call.func))


def _stmt_children(stmt: ast.stmt) -> List[ast.stmt]:
    """Nested statements of a compound statement (not new scopes)."""
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return []
    out: List[ast.stmt] = []
    for field in ("body", "orelse", "finalbody"):
        out.extend(getattr(stmt, field, []) or [])
    for h in getattr(stmt, "handlers", []) or []:
        out.extend(h.body)
    return out


def _flat_stmts(body: Sequence[ast.stmt]) -> Iterable[ast.stmt]:
    """All statements of a function body in source order, same scope only."""
    for st in body:
        yield st
        yield from _flat_stmts(_stmt_children(st))


def _header_nodes(stmt: ast.stmt) -> List[ast.AST]:
    """The statement's own expressions — child exprs, not nested statements."""
    return [n for n in ast.iter_child_nodes(stmt)
            if isinstance(n, (ast.expr, ast.withitem, ast.ExceptHandler))
            and not isinstance(n, (ast.Lambda,))]


def _walk_exprs(nodes: Iterable[ast.AST]) -> Iterable[ast.AST]:
    for n in nodes:
        for sub in ast.walk(n):
            # lambdas are separate (deferred) scopes; their bodies don't
            # execute at this statement
            if isinstance(sub, ast.Lambda):
                continue
            yield sub


def _store_names(stmt: ast.stmt) -> Set[str]:
    """Bare names (re)bound by this statement."""
    out: Set[str] = set()
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, ast.For):
        targets = [stmt.target]
    elif isinstance(stmt, ast.With):
        targets = [i.optional_vars for i in stmt.items if i.optional_vars]
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                out.add(n.id)
    return out


def _store_keys(stmt: ast.stmt) -> Set[Tuple[str, str]]:
    """(kind, name) keys (re)bound: bare names and `self.attr` targets."""
    out: Set[Tuple[str, str]] = set()
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, ast.For):
        targets = [stmt.target]
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                out.add(("name", n.id))
            elif (isinstance(n, ast.Attribute)
                  and isinstance(n.value, ast.Name) and n.value.id == "self"):
                out.add(("self", n.attr))
    return out


class _Module:
    """Per-module analysis context shared by all rules."""

    def __init__(self, tree: ast.Module, source: str, path: str):
        self.tree = tree
        self.path = path
        self.imports = _Imports(tree)
        self.pragmas = pragmas(source)
        self.violations: List[Violation] = []
        self.funcs: List[ast.FunctionDef] = [
            n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        self.by_name: Dict[str, List[ast.FunctionDef]] = {}
        for f in self.funcs:
            self.by_name.setdefault(f.name, []).append(f)
        self.capture_reachable = self._capture_reachable()

    # -- shared infrastructure -------------------------------------------
    def report(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 1)
        allowed = {r for g, r in self.pragmas.get(line, set())
                   if r in GRAMMARS[g] or r == "*"}
        if rule in allowed or "*" in allowed:
            return
        self.violations.append(Violation(
            self.path, line, getattr(node, "col_offset", 0), rule, message))

    @staticmethod
    def _callee_names(call: ast.Call) -> Set[str]:
        out: Set[str] = set()
        if isinstance(call.func, ast.Name):
            out.add(call.func.id)
        elif isinstance(call.func, ast.Attribute):
            out.add(call.func.attr)
        return out

    def _capture_roots(self) -> Set[str]:
        roots: Set[str] = set()
        for node in ast.walk(self.tree):
            # calls inside `with torch.cuda.graph(...):`
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    isinstance(i.context_expr, ast.Call)
                    and self.imports.canon_call(i.context_expr)
                    == "torch.cuda.graph" for i in node.items):
                for stmt in node.body:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Call):
                            roots |= self._callee_names(sub)
            # functions handed to a capturer
            if isinstance(node, ast.Call):
                callee = self.imports.canon_call(node) or ""
                if callee in _CAPTURERS or callee.rsplit(".", 1)[-1] in (
                        _CAPTURERS):
                    for arg in node.args[:1]:
                        if isinstance(arg, ast.Name):
                            roots.add(arg.id)
                        elif isinstance(arg, ast.Attribute):
                            roots.add(arg.attr)
        # calls between set_sync_debug_mode("error") and its reset
        for f in self.funcs:
            on = False
            for stmt in _flat_stmts(f.body):
                for sub in _walk_exprs(_header_nodes(stmt)):
                    if not isinstance(sub, ast.Call):
                        continue
                    if (self.imports.canon_call(sub)
                            == "torch.cuda.set_sync_debug_mode"):
                        arg = sub.args[0] if sub.args else None
                        on = (isinstance(arg, ast.Constant)
                              and arg.value in ("error", 2))
                    elif on:
                        roots |= self._callee_names(sub)
        return roots

    def _called_names(self, f: ast.FunctionDef) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(f):
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Name):
                    out.add(node.func.id)
                elif isinstance(node.func, ast.Attribute):
                    v = node.func.value
                    if isinstance(v, ast.Name) and v.id == "self":
                        out.add(node.func.attr)
        return out

    def _capture_reachable(self) -> Set[ast.FunctionDef]:
        seen: Set[str] = set()
        frontier = list(self._capture_roots())
        reachable: Set[ast.FunctionDef] = set()
        while frontier:
            name = frontier.pop()
            if name in seen:
                continue
            seen.add(name)
            for f in self.by_name.get(name, []):
                reachable.add(f)
                frontier.extend(self._called_names(f))
        return reachable

    # -- rules ------------------------------------------------------------
    def run(self) -> List[Violation]:
        for f in self.funcs:
            self._rule_key_reuse(f)
            self._rule_read_after_overwrite(f)
            if f in self.capture_reachable:
                self._rule_host_read(f)
                self._rule_host_sync(f)
                self._rule_tensor_branch(f)
        self._rule_unguarded_mutation()
        self._rule_lock_discipline()
        self._rule_silent_except()
        self._rule_wall_clock()
        self._check_pragma_rules()
        return self.violations

    def _check_pragma_rules(self) -> None:
        seen: Set[Tuple[int, str, str]] = set()
        for line, names in sorted(self.pragmas.items()):
            for grammar, r in sorted(names):
                if r in GRAMMARS[grammar] or r == "*":
                    continue
                if (line - 1, grammar, r) in seen:
                    continue
                seen.add((line, grammar, r))
                if r in RULES:
                    other = "repro" if r in SHARED else "repro_torch"
                    why = (f"names {r!r} in the `# {grammar}:` grammar; it "
                           f"takes `# {other}: allow[...]`")
                else:
                    why = (f"names unknown rule {r!r} (known: "
                           f"{sorted(RULES)})")
                self.violations.append(Violation(
                    self.path, line, 0, "silent-except", f"pragma {why}"))

    def _rule_key_reuse(self, f: ast.FunctionDef) -> None:
        """A locally-derived key consumed by >1 call without a re-derive."""
        key_names: Set[str] = set()
        uses: Dict[str, int] = {}
        for stmt in _flat_stmts(f.body):
            header = _header_nodes(stmt)
            # 1) consumptions in this statement's expressions
            for node in _walk_exprs(header):
                if not isinstance(node, ast.Call):
                    continue
                callee = self.imports.canon_call(node) or ""
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    if isinstance(arg, ast.Name) and arg.id in key_names:
                        uses[arg.id] = uses.get(arg.id, 0) + 1
                        if uses[arg.id] == 2:
                            self.report(
                                "key-reuse", node,
                                f"PRNG key {arg.id!r} consumed more than once "
                                f"(second consumer: {callee or 'call'}); "
                                "split/fold_in a fresh key per consumer")
            # 2) (re)bindings: key-producing RHS types the targets as keys,
            #    anything else untypes them
            stores = _store_names(stmt)
            produced = False
            if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
                produced = (self.imports.canon_call(stmt.value)
                            in _KEY_PRODUCERS)
            elif (isinstance(stmt, ast.Assign)
                  and isinstance(stmt.value, ast.Subscript)
                  and isinstance(stmt.value.value, ast.Call)):
                produced = (self.imports.canon_call(stmt.value.value)
                            in _KEY_PRODUCERS)
            for name in stores:
                uses[name] = 0
                if produced:
                    key_names.add(name)
                else:
                    key_names.discard(name)

    def _rule_read_after_overwrite(self, f: ast.FunctionDef) -> None:
        """An alias (`a = r`, `a = r.x`, `a = r[i]`) read after its root r
        was overwritten in place: by a `r.f_(...)` method, by a function
        writer given r (`_OVERWRITERS`), or as an argument a method writer
        overwrites (`_METHOD_OVERWRITES`). Reading r itself is fine: it is
        expected to hold the new value."""
        aliases: Dict[str, str] = {}
        dead: Dict[str, int] = {}   # root -> line it was overwritten on

        def root_of(node: ast.AST) -> Optional[str]:
            while isinstance(node, (ast.Attribute, ast.Subscript)):
                node = node.value
            if isinstance(node, ast.Name):
                return aliases.get(node.id, node.id)
            return None

        for stmt in _flat_stmts(f.body):
            header = _header_nodes(stmt)
            # 1) reads of aliases whose root was overwritten
            for node in _walk_exprs(header):
                if not (isinstance(node, ast.Name)
                        and isinstance(node.ctx, ast.Load)):
                    continue
                root = aliases.get(node.id)
                if root is not None and root in dead:
                    self.report(
                        "read-after-overwrite", node,
                        f"{node.id} aliases {root!r}, overwritten in place "
                        f"on line {dead[root]}: it holds the new value; "
                        "clone it before the write to keep the old one")
            # 2) overwrites made by this statement
            for node in _walk_exprs(header):
                if not isinstance(node, ast.Call):
                    continue
                targets: List[ast.AST] = []
                if isinstance(node.func, ast.Attribute):
                    name = node.func.attr
                    if name in _METHOD_OVERWRITES:
                        targets += [node.args[p] for p in
                                    _METHOD_OVERWRITES[name]
                                    if p < len(node.args)]
                    elif (name.endswith("_") and not name.startswith("_")
                          and not name.endswith("__")):
                        targets.append(node.func.value)
                if isinstance(node.func, ast.Name) and (
                        node.func.id in _OVERWRITERS):
                    targets += [node.args[p] for p in
                                _OVERWRITERS[node.func.id]
                                if p < len(node.args)]
                for t in targets:
                    root = root_of(t)
                    if root is not None:
                        dead[root] = node.lineno
            # 3) rebinding: a name bound anew is no longer an alias, and a
            #    root bound anew holds fresh memory
            for name in _store_names(stmt):
                aliases.pop(name, None)
                dead.pop(name, None)
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(stmt.value, (ast.Name, ast.Attribute,
                                                ast.Subscript))):
                root = root_of(stmt.value)
                if root is not None and root != stmt.targets[0].id:
                    aliases[stmt.targets[0].id] = root

    def _rule_host_read(self, f: ast.FunctionDef) -> None:
        for node in ast.walk(f):
            name = None
            if isinstance(node, ast.Call):
                name = self.imports.canon_call(node)
            elif isinstance(node, (ast.Attribute, ast.Subscript)):
                d = self.imports.canon(_dotted(node))
                if d == "os.environ":
                    name = d
            if name is None:
                continue
            if name in _HOST_READS or name.startswith(_HOST_READ_PREFIXES):
                self.report(
                    "host-read-in-capture", node,
                    f"{name} inside capture-reachable `{f.name}`: a replay "
                    "repeats the captured kernels and reads the host never "
                    "again")

    def _tensor_names(self, f: ast.FunctionDef):
        """(statement, the names tensor-valued before it) over f's body:
        a name assigned from a torch call is a tensor, until a non-call
        reassignment."""
        names: Set[str] = set()
        for stmt in _flat_stmts(f.body):
            yield stmt, set(names)
            if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
                if self._is_tensor_call(stmt.value):
                    names |= _store_names(stmt)
            elif isinstance(stmt, ast.Assign):
                names -= _store_names(stmt)

    def _is_tensor_call(self, call: ast.Call) -> bool:
        callee = self.imports.canon_call(call) or ""
        return (callee.startswith(_TENSOR_PREFIXES)
                and not callee.startswith(_NON_TENSOR_PREFIXES))

    def _rule_tensor_branch(self, f: ast.FunctionDef) -> None:
        for stmt, tensor_names in self._tensor_names(f):
            if not isinstance(stmt, (ast.If, ast.While)):
                continue
            bad = self._tracer_in_test(stmt.test, tensor_names)
            if bad:
                self.report(
                    "tensor-branch", stmt,
                    f"Python {'if' if isinstance(stmt, ast.If) else 'while'} "
                    f"on tensor {bad} in capture-reachable `{f.name}`; use "
                    "torch.where")

    def _rule_host_sync(self, f: ast.FunctionDef) -> None:
        for stmt, tensor_names in self._tensor_names(f):
            for node in _walk_exprs(_header_nodes(stmt)):
                if not isinstance(node, ast.Call):
                    continue
                what = None
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _SYNC_METHODS):
                    what = f".{node.func.attr}()"
                elif (isinstance(node.func, ast.Name)
                      and node.func.id in _SYNC_CASTS and node.args
                      and (self._is_tensor_arg(node.args[0], tensor_names))):
                    what = f"{node.func.id}() of a tensor"
                if what:
                    self.report(
                        "host-sync-in-capture", node,
                        f"{what} in capture-reachable `{f.name}` syncs the "
                        "host with the card")

    def _is_tensor_arg(self, arg: ast.expr, tensor_names: Set[str]) -> bool:
        return ((isinstance(arg, ast.Name) and arg.id in tensor_names)
                or (isinstance(arg, ast.Call) and self._is_tensor_call(arg)))

    def _tracer_in_test(self, test: ast.expr, tracer_names: Set[str]
                        ) -> Optional[str]:
        parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(test):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        for node in ast.walk(test):
            if isinstance(node, ast.Call) and self._is_tensor_call(node):
                return self.imports.canon_call(node)
            if (isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)
                    and node.id in tracer_names):
                parent = parents.get(node)
                if (isinstance(parent, ast.Attribute)
                        and parent.attr in _STATIC_ATTRS):
                    continue  # x.shape / x.ndim are host values
                return node.id
        return None

    def _rule_unguarded_mutation(self) -> None:
        for cls in ast.walk(self.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            locks = self._lock_attrs(cls)
            if not locks:
                continue
            for meth in cls.body:
                if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if meth.name == "__init__":
                    continue
                self._scan_mutations(meth, locks, guarded=False)

    def _lock_attrs(self, cls: ast.ClassDef) -> Set[str]:
        locks: Set[str] = set()
        for node in ast.walk(cls):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            if self.imports.canon_call(node.value) not in _LOCK_FACTORIES:
                continue
            for t in node.targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    locks.add(t.attr)
        return locks

    def _scan_mutations(self, node, locks: Set[str], guarded: bool) -> None:
        for stmt in (node.body if hasattr(node, "body") else []):
            now_guarded = guarded
            if isinstance(stmt, ast.With):
                for item in stmt.items:
                    d = _dotted(item.context_expr)
                    if d and d.startswith("self.") and d[5:] in locks:
                        now_guarded = True
            if not now_guarded and isinstance(
                    stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets: List[ast.AST] = (
                    list(stmt.targets) if isinstance(stmt, ast.Assign)
                    else [stmt.target])
                # descend into tuple/list unpacking targets
                flat: List[ast.AST] = []
                while targets:
                    t = targets.pop()
                    if isinstance(t, (ast.Tuple, ast.List)):
                        targets.extend(t.elts)
                    else:
                        flat.append(t)
                for t in flat:
                    base = t
                    while isinstance(base, (ast.Subscript, ast.Starred)):
                        base = base.value
                    if (isinstance(base, ast.Attribute)
                            and isinstance(base.value, ast.Name)
                            and base.value.id == "self"
                            and base.attr not in locks):
                        self.report(
                            "unguarded-mutation", stmt,
                            f"self.{base.attr} mutated outside "
                            f"`with self.{sorted(locks)[0]}:` in a "
                            "lock-owning class")
            # recurse into nested statements with the (possibly) new guard
            for child in _stmt_children(stmt):
                self._scan_mutations_stmt(child, locks, now_guarded)

    def _scan_mutations_stmt(self, stmt: ast.stmt, locks: Set[str],
                             guarded: bool) -> None:
        class _Shim:
            body = [stmt]
        self._scan_mutations(_Shim, locks, guarded)

    def _lock_scan(self, meth, locks: Set[str]):
        """(guarded_writes, unguarded_writes, calls, acquires) for one
        method: which self fields it writes under / outside `with
        self.<lock>:`, which self methods it calls (and under which guard
        state), and whether it ever takes a lock itself."""
        guarded_w: Set[str] = set()
        unguarded_w: List[Tuple[str, ast.stmt]] = []
        calls: List[Tuple[str, ast.AST, bool]] = []
        acquires = False

        def walk(stmts, guarded):
            nonlocal acquires
            for stmt in stmts:
                g = guarded
                if isinstance(stmt, ast.With):
                    for item in stmt.items:
                        d = _dotted(item.context_expr)
                        if d and d.startswith("self.") and d[5:] in locks:
                            g = acquires = True
                for kind, attr in _store_keys(stmt):
                    if kind != "self" or attr in locks:
                        continue
                    if g:
                        guarded_w.add(attr)
                    else:
                        unguarded_w.append((attr, stmt))
                for node in _walk_exprs(_header_nodes(stmt)):
                    if (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and isinstance(node.func.value, ast.Name)
                            and node.func.value.id == "self"):
                        calls.append((node.func.attr, node, g))
                walk(_stmt_children(stmt), g)

        walk(meth.body, False)
        return guarded_w, unguarded_w, calls, acquires

    def _rule_lock_discipline(self) -> None:
        """Per lock-owning class: fields written under the lock anywhere
        define the guarded set; a write to a guarded field without the
        lock — or a call, without the lock, to a helper whose writes are
        only correct because its callers normally hold it — breaks the
        discipline. Finer than unguarded-mutation (which flags every bare
        self-write): this one follows the *field* across methods and
        through one level of helper calls."""
        for cls in ast.walk(self.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            locks = self._lock_attrs(cls)
            if not locks:
                continue
            methods = [m for m in cls.body
                       if isinstance(m, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
            scans = {m.name: self._lock_scan(m, locks) for m in methods}
            guarded_fields: Set[str] = set()
            for name, (gw, _, _, _) in scans.items():
                if name != "__init__":
                    guarded_fields |= gw
            # helpers: never take the lock themselves, write fields bare,
            # and have at least one lock-held call site — i.e. they *rely*
            # on the caller's guard, so their writes are guarded by
            # convention and every bare call site breaks it
            guarded_sites: Set[str] = set()
            for name, (_, _, calls, _) in scans.items():
                guarded_sites |= {c for c, _, g in calls if g}
            helpers = {
                name for name, (_, uw, _, acq) in scans.items()
                if name != "__init__" and not acq and name in guarded_sites
                and uw}
            for name in helpers:
                guarded_fields |= {a for a, _ in scans[name][1]}
            if not guarded_fields:
                continue
            for meth in methods:
                if meth.name == "__init__":
                    continue
                _, unguarded_w, calls, _ = scans[meth.name]
                if meth.name not in helpers:
                    for attr, stmt in unguarded_w:
                        if attr in guarded_fields:
                            self.report(
                                "lock-discipline", stmt,
                                f"self.{attr} is written under "
                                f"self.{sorted(locks)[0]} elsewhere in "
                                f"{cls.name} but written here without the "
                                "lock — a concurrent writer can interleave")
                for callee, node, g in calls:
                    if callee in helpers and not g:
                        fields = sorted({a for a, _ in scans[callee][1]}
                                        & guarded_fields)
                        self.report(
                            "lock-discipline", node,
                            f"self.{callee}() writes lock-guarded "
                            f"{', '.join('self.' + a for a in fields)} and "
                            "its other call sites hold "
                            f"self.{sorted(locks)[0]} — call it with the "
                            "lock held")

    def _rule_silent_except(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not self._is_broad(node.type):
                continue
            if self._handler_is_loud(node):
                continue
            self.report(
                "silent-except", node,
                "broad except swallows the error silently — narrow the "
                "exception type, or log and re-raise the unexpected")

    def _is_broad(self, type_node: Optional[ast.expr]) -> bool:
        if type_node is None:
            return True
        names = ([type_node] if not isinstance(type_node, ast.Tuple)
                 else list(type_node.elts))
        for n in names:
            if self.imports.canon(_dotted(n)) in ("Exception", "BaseException"):
                return True
        return False

    def _handler_is_loud(self, handler: ast.ExceptHandler) -> bool:
        for node in ast.walk(handler):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Call):
                d = (self.imports.canon_call(node) or "").lower()
                if any(m in d for m in _LOG_MARKERS):
                    return True
        return False

    def _rule_wall_clock(self) -> None:
        for node in ast.walk(self.tree):
            if (isinstance(node, ast.Call)
                    and self.imports.canon_call(node) == "time.time"):
                self.report(
                    "wall-clock", node,
                    "time.time() is not monotonic; use time.perf_counter() "
                    "for durations (time.monotonic() for deadlines)")


def lint_source(source: str, path: str = "<string>",
                select: Optional[Set[str]] = None) -> List[Violation]:
    """Lint one module's source; `select` restricts to a subset of rules."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Violation(path, e.lineno or 1, e.offset or 0, "silent-except",
                          f"syntax error: {e.msg}")]
    out = _Module(tree, source, path).run()
    if select is not None:
        out = [v for v in out if v.rule in select]
    return sorted(out, key=lambda v: (v.path, v.line, v.col))


def lint_paths(paths: Iterable[str],
               select: Optional[Set[str]] = None) -> List[Violation]:
    """Lint every `.py` file under `paths` (files or directories)."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, names in os.walk(p):
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith(".py"))
        else:
            files.append(p)
    out: List[Violation] = []
    for path in sorted(set(files)):
        with open(path, encoding="utf-8") as f:
            out.extend(lint_source(f.read(), path, select=select))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="the port's AST lint (rules: %s)" % ", ".join(sorted(RULES)))
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument("--select", default="",
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--json", default="", metavar="PATH",
                    help="also write violations as JSON")
    args = ap.parse_args(argv)
    select = {r.strip() for r in args.select.split(",") if r.strip()} or None
    if select and (unknown := select - set(RULES)):
        ap.error(f"unknown rules {sorted(unknown)}; known: {sorted(RULES)}")
    violations = lint_paths(args.paths, select=select)
    for v in violations:
        print(v)
    if args.json:
        with open(args.json, "w") as f:
            json.dump([v.__dict__ for v in violations], f, indent=2)
    n = len(violations)
    print(f"repro_torch.analysis.lint: {n} violation{'s' if n != 1 else ''} "
          f"in {', '.join(args.paths)}")
    return 1 if violations else 0


if __name__ == "__main__":
    raise SystemExit(main())
