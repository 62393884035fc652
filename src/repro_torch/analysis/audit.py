"""Step-path audit: every env id × step backend, and the fused train units
(port of `repro.analysis.audit`).

`python -m repro_torch.analysis.audit --smoke --json PATH [--device cpu]`

The JAX audit lowers each pool's donated step program and reads the HLO.
The port runs eagerly, so its audit runs one step of each pool and
watches it:

  residency : the step runs under `torch.cuda.set_sync_debug_mode("error")`
              (a host sync raises), and the dispatcher sees no copy
              between host and device memory in it (`_Watch`). The async
              recv's one copy of its outputs to the host (`_fetch`) is the
              one allowed: `COPY_BUDGET`, named as the JAX audit names its
              retrace budget. (The profiler's device events were the first
              design; on an H100 with PyTorch 2.11 some windows came back
              with part of their kernels, or none, so the gate counts at
              the dispatcher, which sees every op a step asks for);
  in place  : every carry leaf keeps its memory across the step
              (`launch/graph_analysis.py::written_in_place`, the port's
              donation: core/carry.py);
  launches  : the async recv launches as much (device ops plus the
              port's kernels) for ready sets of 1, 2 and every slot
              (`READY_SIZES`): the port's counterpart of
              the JAX audit's retrace budget, since a kernel is built once
              and a shape never retraces, but a path that looped over the
              ready lanes would launch more;
  train     : each GOLDEN_TRAIN_IDS unit captured as `run_fused` replays
              it (`train/fused.py::lower_train_chunk`) holds no host node
              and no host copy (`host_transfer_ops`), and a replay writes
              the carry in place.

Backends that cannot host an id refuse by a named exception (the fused
backends without a megastep spec: ValueError; a body that does not fit
the instance: NotImplementedError; the async pool on an env without the
functional API: AsyncUnsupportedError). A refusal is a row; any other
exception is a violation.

On the CPU (`--device cpu`) the same code runs the "vmap" and "torch" (the
plain megastep) rows: refusals, the carry written in place and the report's
schema. Residency, launch counts and the train rows need the card. No
report file is committed: `--json` writes one where it is told.
"""
from __future__ import annotations

import argparse
import json
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core.registry import registered
from repro_torch.device import resolve_device
from repro_torch.launch.graph_analysis import leaf_ptrs, written_in_place

#: step paths audited per id on the card (the four of the JAX audit, its
#: "pallas" being the port's "cuda")
BACKENDS = ("vmap", "cuda", "async", "sharded")
#: step paths audited per id on the CPU: "torch" is the plain megastep
CPU_BACKENDS = ("vmap", "torch")
#: backend tag of the train rows (ids "<algo>/<env_id>")
TRAIN_BACKEND = "train_fused"
#: refusal classes that mean "this backend cannot host this id"
EXPECTED_REFUSALS = ("ValueError", "NotImplementedError",
                     "AsyncUnsupportedError")
#: host<->device copies a step path may make: the async recv's one copy of
#: its packed outputs to the host (`AsyncEnvPool._fetch`)
COPY_BUDGET: Dict[str, int] = {"async": 1}
#: ready-set sizes of the async launch gate; None stands for every slot
READY_SIZES = (1, 2, None)
#: aten ops that move no data and launch nothing (views, allocations)
NO_DATA_OPS = ("empty", "empty_like", "empty_strided", "view",
               "_unsafe_view", "reshape", "expand", "permute", "transpose",
               "t", "select", "slice", "unsqueeze", "squeeze", "as_strided",
               "alias", "detach", "unbind", "split", "split_with_sizes",
               "chunk", "lift_fresh")


def backends_for(device) -> Tuple[str, ...]:
    return BACKENDS if torch.device(device).type == "cuda" else CPU_BACKENDS


def _build_pool(env_id: str, backend: str, batch: int, device):
    """The pool under audit (may raise a refusal)."""
    from repro_torch.pool import AsyncEnvPool, EnvPool, ShardedEnvPool

    if backend in ("vmap", "cuda", "torch"):
        return EnvPool(env_id, batch, backend=backend, device=device)
    if backend == "async":
        return AsyncEnvPool(env_id, batch, backend="auto", device=device)
    if backend == "sharded":
        return ShardedEnvPool(env_id, batch, mesh=(device,))
    raise ValueError(f"unknown audit backend {backend!r}")


class _Watch(TorchDispatchMode):
    """What a step asks of the card, as the dispatcher sees it: the ops
    that run on a device (views and allocations aside) and the copies
    between host and device memory (a `copy_` or `_to_copy` across the
    two, a scalar read)."""

    def __init__(self):
        super().__init__()
        self.ops, self.copies = Counter(), []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__.split(".")[0]
        tensors = [x for x in tree_leaves((args, kwargs, out))
                   if isinstance(x, torch.Tensor)]
        devices = {x.device.type for x in tensors}
        if name == "_local_scalar_dense" and "cpu" not in devices:
            self.copies.append(name)
        elif name in ("copy_", "_to_copy", "copy") and len(devices) > 1 and (
                "cpu" in devices):
            self.copies.append(f"{name} {'/'.join(sorted(devices))}")
        if devices - {"cpu"} and name not in NO_DATA_OPS:
            self.ops[name] += 1
        return out


def _watched(fn) -> Tuple[List[str], int]:
    """(host<->device copies, launches) of `fn()`: the dispatcher's device
    ops (`_Watch`) plus the port's own kernels' launches."""
    from repro_torch.kernels import launch_counters

    counters = launch_counters()
    before = {k: f.launches for k, f in counters.items()}
    with _Watch() as watch:
        fn()
    kernels = sum(f.launches - before[k] for k, f in counters.items())
    return watch.copies, sum(watch.ops.values()) + kernels


def _sync_free(fn):
    """`fn()` with host syncs raising."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _actions(pool, n: int):
    return pool.sample_actions(0)[:n]


def _audit_lockstep(row, pool, device) -> None:
    """One stateful step of an EnvPool or ShardedEnvPool, after a warm
    one."""
    pool.reset(0)
    acts = _actions(pool, pool.num_envs)
    pool.step(acts)                       # builds the kernels, warms up
    before = leaf_ptrs(pool._carry)
    if device.type == "cuda":
        copies, launches = _watched(lambda: _sync_free(
            lambda: pool.step(acts)))
        row.update(host_copies=copies, launches=launches, sync_free=True)
    else:
        pool.step(acts)
    row["moved_leaves"] = written_in_place(before, pool._carry)
    row["carry_leaves"] = len(before)


def _recv_parts(pool, sids, acts):
    """send, then the recv's host staging (outside the audited window) ->
    the audited part: the masked step and the copy out."""
    pool.send(acts, sids)
    with pool._cond, pool._on_stream():
        _, staged = pool._stage_ready(None)

    def step():
        with pool._cond, pool._on_stream():
            packed = _sync_free(lambda: pool._step_ready(staged))
            return pool._fetch(packed)
    return step


def _audit_async(row, pool, device) -> None:
    """The async recv's masked step at each READY_SIZES ready set: its
    copies and kernels, the carry in place."""
    sids = [pool.admit(seed=i)[0] for i in range(pool.num_slots)]
    acts = np.asarray(_actions(pool, pool.num_slots).cpu())
    _recv_parts(pool, sids, acts)()       # builds the kernels, warms up
    carry = lambda: (pool._state, pool._obs)
    before = leaf_ptrs(carry())
    launches, copies = {}, []
    for size in READY_SIZES:
        n = len(sids) if size is None else min(size, len(sids))
        step = _recv_parts(pool, sids[:n], acts[:n])
        if device.type == "cuda":
            got, launches[str(n)] = _watched(step)
            copies = max(copies, got, key=len)
        else:
            step()
    row["moved_leaves"] = written_in_place(before, carry())
    row["carry_leaves"] = len(before)
    if device.type == "cuda":
        row.update(host_copies=copies, launches=max(launches.values()),
                   sync_free=True, launches_by_ready_set=launches)


def audit_cell(env_id: str, backend: str, batch: int,
               device=None) -> Dict[str, Any]:
    """Audit one (id, backend) cell on `device` (the card when None);
    returns its report row."""
    device = resolve_device(device)
    row: Dict[str, Any] = {"id": env_id, "backend": backend, "batch": batch,
                           "device": str(device)}
    try:
        pool = _build_pool(env_id, backend, batch, device)
    except Exception as e:  # repro: allow[silent-except] named-refusal protocol: class+message recorded in the row, judged against EXPECTED_REFUSALS
        row.update(status="refused", refusal=type(e).__name__,
                   refusal_msg=str(e).splitlines()[0][:200])
        return row
    row.update(status="ok", step_backend=pool.backend,
               copy_budget=COPY_BUDGET.get(backend, 0))
    if backend == "async":
        _audit_async(row, pool, device)
    else:
        _audit_lockstep(row, pool, device)
    row["in_place"] = 1.0 - len(row["moved_leaves"]) / max(
        row["carry_leaves"], 1)
    return row


def audit_train_cell(gid: str, chunk: int = 8, device=None) -> Dict[str, Any]:
    """Audit one fused train unit (a GOLDEN_TRAIN_IDS "<algo>/<env_id>"
    id): the graph `run_fused` replays holds no host node and no host copy,
    and a replay writes its carry in place (every leaf keeps its memory
    and the key chain advances)."""
    from repro_torch.train.fused import golden_train_setup, lower_train_chunk

    device = resolve_device(device)
    row: Dict[str, Any] = {"id": gid, "backend": TRAIN_BACKEND,
                           "chunk": chunk, "device": str(device)}
    try:
        algo, env_id, cfg, _ = golden_train_setup(gid)
        row["batch"] = cfg.num_envs
        graph, carry = lower_train_chunk(algo, env_id, cfg, chunk=chunk,
                                         device=device)
    except Exception as e:  # repro: allow[silent-except] named-refusal protocol (see audit_cell)
        row.update(status="refused", refusal=type(e).__name__,
                   refusal_msg=str(e).splitlines()[0][:200])
        return row
    from repro_torch.launch.graph_analysis import graph_nodes, host_transfer_nodes

    nodes = graph_nodes(graph)
    before = leaf_ptrs(carry)
    leaves = [x for x in torch.utils._pytree.tree_leaves(carry)
              if isinstance(x, torch.Tensor)]
    old = [x.clone() for x in leaves]
    graph.replay()
    torch.cuda.synchronize()
    row.update(status="ok", graph_nodes=len(nodes),
               node_types=sorted({n["type"] for n in nodes}),
               host_transfer_ops=host_transfer_nodes(nodes),
               moved_leaves=written_in_place(before, carry),
               carry_leaves=len(before),
               leaves_written=sum(not torch.equal(a, b)
                                  for a, b in zip(old, leaves)))
    row["in_place"] = 1.0 - len(row["moved_leaves"]) / max(len(before), 1)
    return row


def row_violations(row: Dict[str, Any]) -> List[str]:
    """Gate one row; returns the violations (empty = ok)."""
    tag = f"{row['id']}×{row['backend']}"
    if row["status"] == "refused":
        if row["refusal"] in EXPECTED_REFUSALS:
            return []
        return [f"{tag}: unexpected refusal {row['refusal']}: "
                f"{row.get('refusal_msg', '')}"]
    out = []
    if row["moved_leaves"]:
        out.append(f"{tag}: {len(row['moved_leaves'])}/{row['carry_leaves']}"
                   f" carry leaves not written in place: "
                   f"{row['moved_leaves'][:3]}")
    if row.get("host_transfer_ops"):
        out.append(f"{tag}: {len(row['host_transfer_ops'])} host node(s) or "
                   f"host copies in the captured graph: "
                   f"{row['host_transfer_ops'][:3]}")
    if row["backend"] == TRAIN_BACKEND:
        if not row.get("graph_nodes"):
            out.append(f"{tag}: the captured graph shows no node")
        if not row.get("leaves_written"):
            out.append(f"{tag}: a replay wrote no carry leaf")
        return out
    if "host_copies" in row:
        if len(row["host_copies"]) > row["copy_budget"]:
            out.append(f"{tag}: {len(row['host_copies'])} host<->device "
                       f"copies on the step path exceed the budget of "
                       f"{row['copy_budget']}: {row['host_copies'][:3]}")
        if not row["launches"]:
            out.append(f"{tag}: the step launched nothing on the card")
    launches = row.get("launches_by_ready_set")
    if launches and len(set(launches.values())) > 1:
        out.append(f"{tag}: kernel launches differ across ready-set sizes "
                   f"{launches}")
    return out


def plan(ids: Optional[Sequence[str]] = None,
         backends: Sequence[str] = BACKENDS) -> List[Tuple[str, str]]:
    """The audit matrix: every registry id × every backend."""
    ids = list(ids) if ids else sorted(registered())
    return [(i, b) for i in ids for b in backends]


def run(ids: Optional[Sequence[str]] = None,
        backends: Optional[Sequence[str]] = None, batch: int = 4,
        smoke: bool = True, train: Optional[bool] = None, device=None,
        progress=None) -> Dict[str, Any]:
    """Run the sweep on `device` (the card when None); returns the report.
    `train` adds the train rows; None means on for a full-registry sweep
    on the card, off with an `ids` subset or on the CPU."""
    device = resolve_device(device)
    backends = tuple(backends or backends_for(device))
    cells = plan(ids, backends)
    if train is None:
        train = ids is None and device.type == "cuda"
    rows, violations = [], []
    for env_id, backend in cells:
        row = audit_cell(env_id, backend, batch, device)
        rows.append(row)
        violations.extend(row_violations(row))
        if progress:
            progress(row)
    train_ids: Tuple[str, ...] = ()
    if train:
        from repro_torch.train.fused import GOLDEN_TRAIN_IDS

        train_ids = GOLDEN_TRAIN_IDS
        for gid in train_ids:
            row = audit_train_cell(gid, device=device)
            rows.append(row)
            violations.extend(row_violations(row))
            if progress:
                progress(row)
    hosted = [r for r in rows if r["status"] == "ok"]
    return {
        "meta": {
            "smoke": smoke,
            "batch": batch,
            "torch": torch.__version__,
            "device": str(device),
            "device_name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
            "backends": list(backends),
            "ids": sorted({c[0] for c in cells}),
            "train_cells": list(train_ids),
            "copy_budget": dict(COPY_BUDGET),
        },
        "rows": rows,
        "summary": {
            "cells": len(rows),
            "hosted": len(hosted),
            "refused": len(rows) - len(hosted),
            "in_place": sum(r["in_place"] == 1.0 for r in hosted),
            "host_resident": sum(not r.get("host_transfer_ops")
                                 and len(r.get("host_copies", ()))
                                 <= r.get("copy_budget", 0)
                                 for r in hosted),
        },
        "violations": violations,
        "ok": not violations,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit",
        description="step-path audit (residency / in place / launch gates)")
    ap.add_argument("--smoke", action="store_true",
                    help="small batch (4 slots; the default is 16)")
    ap.add_argument("--ids", default="",
                    help="comma-separated id subset (default: full registry)")
    ap.add_argument("--backends", default="",
                    help=f"comma-separated subset of {BACKENDS} on the card, "
                         f"{CPU_BACKENDS} on the CPU")
    ap.add_argument("--batch", type=int, default=0,
                    help="envs/slots per pool (default: 4 smoke, 16 full)")
    ap.add_argument("--train", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="audit the fused train units too (default: on for "
                         "full-registry sweeps on the card)")
    ap.add_argument("--device", default=None,
                    help="the device (default: the CUDA card)")
    ap.add_argument("--json", default="", metavar="PATH",
                    help="write the report as JSON")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ids = [i.strip() for i in args.ids.split(",") if i.strip()] or None
    backends = tuple(b.strip() for b in args.backends.split(",")
                     if b.strip()) or backends_for(device)
    if unknown := set(backends) - set(backends_for(device)):
        ap.error(f"unknown backends {sorted(unknown)} on {device}; expected "
                 f"{backends_for(device)}")
    batch = args.batch or (4 if args.smoke else 16)

    def progress(row):
        if row["status"] == "ok":
            detail = (f"in place {row['carry_leaves'] - len(row['moved_leaves'])}"
                      f"/{row['carry_leaves']}")
            if "host_copies" in row:
                detail += (f", {len(row['host_copies'])}/{row['copy_budget']} "
                           f"host copies, {row['launches']} launches")
            if "host_transfer_ops" in row:
                detail += (f", {row['graph_nodes']} graph nodes, "
                           f"{len(row['host_transfer_ops'])} host")
        else:
            detail = f"refused: {row['refusal']}"
        print(f"  {row['id']:>18} × {row['backend']:<11} {row['status']:<7} "
              f"{detail}", flush=True)

    report = run(ids=ids, backends=backends, batch=batch, smoke=args.smoke,
                 train=args.train, device=device, progress=progress)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
    s = report["summary"]
    print(f"repro_torch.analysis.audit: {s['cells']} cells "
          f"({s['hosted']} hosted, {s['refused']} refused), "
          f"{s['in_place']}/{s['hosted']} written in place, "
          f"{s['host_resident']}/{s['hosted']} host-resident, "
          f"{len(report['violations'])} violation(s)")
    for v in report["violations"]:
        print(f"  VIOLATION: {v}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
