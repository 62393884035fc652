"""Static cost model and its regression gate (port of
`repro.analysis.cost`).

`python -m repro_torch.analysis.cost --smoke [--device cpu] [--json PATH]`

The JAX model reads flops and bytes off the compiled HLO. The port
compiles none, so a cell's work is counted from what one step runs:

  - each kernel dispatch logs its wrapper's `cost` (the counts behind
    PERF.md's recounted bounds: kernels/envstep/megastep.py,
    kernels/raster/raster.py, kernels/attention/flash.py), for the launch
    it makes on the card or the plain twin it runs on the CPU; the same
    work whatever implements it;
  - the aten ops around the kernels: their flops by
    `torch.utils.flop_counter.FlopCounterMode` (matrix products,
    convolutions), their bytes as XLA counts "bytes accessed": each op's
    operand and output bytes (views and allocations move nothing).

Per env step (env steps of one launch: the batch, times the rollout of a
PPO update): flops and bytes, the roofline position against the ceilings
of an NVIDIA H100 SXM5 80GB at its 700 W power limit (its data sheet:
bf16 989 TFLOP/s dense on the tensor cores, f32 67 TFLOP/s, HBM3 3.35
TB/s), and `static_impact`: `StaticImpact` charging the roofline bound at
that power limit. On the card `peak_live_bytes` is the allocator's peak
over the step.

`check(report, baseline)` diffs GATED_METRICS against a baseline report
with per-family thresholds, as the JAX gate does. No baseline file is
committed: which one gates is the benchmark's decision.
"""
from __future__ import annotations

import argparse
import contextlib
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.audit import (BACKENDS, CPU_BACKENDS,
                                        EXPECTED_REFUSALS, NO_DATA_OPS,
                                        TRAIN_BACKEND, _build_pool)
from repro_torch.core.registry import registered, spec
from repro_torch.device import resolve_device
from repro_torch.sustainability.impact import StaticImpact

#: the card the roofline is drawn for, and its ceilings (NVIDIA's data
#: sheet, dense rates; they assume the full power limit)
CARD = "NVIDIA H100 SXM5 80GB"
POWER_LIMIT_WATTS = 700.0
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

#: backends costed in smoke mode on the card (the two step kernels'
#: paths); on the CPU "torch" is the plain megastep
SMOKE_BACKENDS = ("vmap", "cuda")

#: metrics the regression gate diffs against a baseline
GATED_METRICS = ("flops_per_step", "bytes_per_step", "peak_live_bytes")
#: per-family relative regression thresholds (the JAX gate's)
DEFAULT_THRESHOLDS: Dict[str, float] = {
    "classic": 0.10, "grid": 0.10, "puzzle": 0.10, "flash": 0.10,
    "arcade": 0.15, "train": 0.15,
}
FALLBACK_THRESHOLD = 0.10
_FAMILIES = ("classic", "grid", "arcade", "puzzle", "flash")


def family_of(env_id: str, backend: str = "vmap") -> str:
    """The threshold bucket of a cell: its registry tag, or "train"."""
    if backend == TRAIN_BACKEND:
        return "train"
    tags = spec(env_id).tags
    for fam in _FAMILIES:
        if fam in tags:
            return fam
    return "other"


def threshold_for(family: str,
                  thresholds: Optional[Dict[str, float]] = None) -> float:
    return (thresholds or DEFAULT_THRESHOLDS).get(family, FALLBACK_THRESHOLD)


class _BytesMode(TorchDispatchMode):
    """Operand and output bytes of every aten op that moves data."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.__name__.split(".")[0] not in NO_DATA_OPS:
            self.bytes += sum(x.numel() * x.element_size()
                              for x in tree_leaves((args, kwargs, out))
                              if isinstance(x, torch.Tensor))
        return out


@contextlib.contextmanager
def counting():
    """Count the work of what runs inside: yields a dict filled on exit
    with each kernel's launches and summed `cost` ({name: {"launches", ...
    the cost's keys}}), "aten_flops" and "aten_bytes"."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import kernels

    saved, log, out = kernels.COST_LOG, [], {}
    kernels.COST_LOG = log
    try:
        with FlopCounterMode(display=False) as flops, _BytesMode() as nbytes:
            yield out
    finally:
        kernels.COST_LOG = saved
    for name, thunk in log:
        row = out.setdefault(name, {"launches": 0})
        row["launches"] += 1
        for k, v in thunk().items():
            row[k] = row.get(k, 0) + v
    out["aten_flops"] = int(flops.get_total_flops())
    out["aten_bytes"] = int(nbytes.bytes)


def work_of(counted: Dict[str, Any]) -> Tuple[float, float]:
    """(flops, bytes) of a `counting()` result: the kernels' ops (megastep
    int32 and float ops, raster ops, flash flops) and bytes, plus the aten
    ops'."""
    flops = float(counted["aten_flops"])
    nbytes = float(counted["aten_bytes"])
    for name, row in counted.items():
        if isinstance(row, dict):
            flops += sum(row.get(k, 0) for k in ("int_ops", "float_ops",
                                                 "ops", "flops"))
            nbytes += row.get("bytes", 0)
    return flops, nbytes


def roofline(flops: float, nbytes: float, dtype: str = "float32"
             ) -> Dict[str, Any]:
    """Where work sits against the card's ceilings: the compute and memory
    times, the larger as the bound, and the intensity against the balance
    point."""
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS
    compute_s, memory_s = flops / peak, nbytes / HBM_BYTES_PER_S
    balance = peak / HBM_BYTES_PER_S
    intensity = flops / nbytes if nbytes else 0.0
    return {"compute_s": compute_s, "memory_s": memory_s,
            "bound_s": max(compute_s, memory_s),
            "dominant": "compute" if compute_s > memory_s else "memory",
            "peak_flops": peak, "balance_intensity": balance,
            "intensity_vs_balance": intensity / balance,
            "card": CARD, "power_limit_watts": POWER_LIMIT_WATTS}


def static_impact(bound_s: float) -> Dict[str, float]:
    """StaticImpact of a roofline bound at the card's power limit."""
    return StaticImpact(seconds_per_step=bound_s,
                        watts=POWER_LIMIT_WATTS).report()


def _record(row: Dict[str, Any], counted: Dict[str, Any], steps: int,
            peak: Optional[int]) -> Dict[str, Any]:
    flops, nbytes = work_of(counted)
    n = max(steps, 1)
    rl = roofline(flops / n, nbytes / n)
    row.update(status="ok", env_steps_per_program=steps, flops=flops,
               bytes=nbytes, flops_per_step=flops / n,
               bytes_per_step=nbytes / n,
               arithmetic_intensity=flops / nbytes if nbytes else 0.0,
               peak_live_bytes=peak, roofline=rl,
               static_impact=static_impact(rl["bound_s"]),
               kernels={k: v for k, v in counted.items()
                        if isinstance(v, dict)},
               aten={"flops": counted["aten_flops"],
                     "bytes": counted["aten_bytes"]})
    return row


def _refused(row, e):
    row.update(status="refused", refusal=type(e).__name__,
               refusal_msg=str(e).splitlines()[0][:200])
    return row


def cost_cell(env_id: str, backend: str, batch: int,
              device=None) -> Dict[str, Any]:
    """Cost one stateful step of one (id, backend) pool cell: refusals are
    rows, as in the audit."""
    from repro_torch.launch.graph_analysis import peak_live_bytes

    device = resolve_device(device)
    row: Dict[str, Any] = {"id": env_id, "backend": backend, "batch": batch,
                           "family": family_of(env_id, backend),
                           "device": str(device)}
    try:
        pool = _build_pool(env_id, backend, batch, device)
    except Exception as e:  # repro: allow[silent-except] named-refusal protocol: class+message recorded, judged against EXPECTED_REFUSALS
        return _refused(row, e)
    if backend == "async":
        sids = [pool.admit(seed=i)[0] for i in range(pool.num_slots)]
        acts = pool.sample_actions(0).cpu().numpy()

        def step():
            pool.send(acts, sids)
            pool.recv()
    else:
        pool.reset(0)
        acts = pool.sample_actions(0)
        step = lambda: pool.step(acts)
    step()                                  # builds the kernels, warms up
    with counting() as counted:
        step()
    peak = peak_live_bytes(step, device) if device.type == "cuda" else None
    return _record(row, counted, batch, peak)


def cost_train_cell(gid: str, device=None) -> Dict[str, Any]:
    """Cost one eager train step of a GOLDEN_TRAIN_IDS configuration (the
    step a fused unit captures). Env steps a step: the envs, times the
    rollout of a PPO update."""
    from repro_torch import random as R
    from repro_torch.core.registry import make
    from repro_torch.launch.graph_analysis import peak_live_bytes
    from repro_torch.train.fused import _algo_parts, golden_train_setup

    device = resolve_device(device)
    row: Dict[str, Any] = {"id": gid, "backend": TRAIN_BACKEND,
                           "family": "train", "device": str(device)}
    algo, env_id, cfg, _ = golden_train_setup(gid)
    row["batch"] = cfg.num_envs
    _, init_row, step_fn = _algo_parts(make(env_id), algo, cfg, device)
    carry = [init_row(R.PRNGKey(0, device))]

    def step():
        carry[0], _ = step_fn(carry[0])

    step()
    with counting() as counted:
        step()
    peak = peak_live_bytes(step, device) if device.type == "cuda" else None
    steps = cfg.num_envs * getattr(cfg, "rollout_len", 1)
    return _record(row, counted, steps, peak)


def plan(ids: Optional[Sequence[str]] = None,
         backends: Sequence[str] = SMOKE_BACKENDS) -> List[Tuple[str, str]]:
    ids = list(ids) if ids else sorted(registered())
    return [(i, b) for i in ids for b in backends]


def run(ids: Optional[Sequence[str]] = None,
        backends: Optional[Sequence[str]] = None, batch: int = 4,
        smoke: bool = True, train: Optional[bool] = None, device=None,
        progress=None) -> Dict[str, Any]:
    """Run the cost sweep on `device` (the card when None); `train=None`
    adds the train rows for a full-registry sweep."""
    device = resolve_device(device)
    if backends is None:
        backends = (CPU_BACKENDS if device.type != "cuda"
                    else SMOKE_BACKENDS if smoke else BACKENDS)
    cells = plan(ids, backends)
    train = (ids is None) if train is None else train
    rows: List[Dict[str, Any]] = []
    for env_id, backend in cells:
        rows.append(cost_cell(env_id, backend, batch, device))
        if progress:
            progress(rows[-1])
    train_ids: Tuple[str, ...] = ()
    if train:
        from repro_torch.train.fused import GOLDEN_TRAIN_IDS

        train_ids = GOLDEN_TRAIN_IDS
        for gid in train_ids:
            rows.append(cost_train_cell(gid, device))
            if progress:
                progress(rows[-1])
    hosted = [r for r in rows if r["status"] == "ok"]
    unexpected = [r for r in rows if r["status"] == "refused"
                  and r["refusal"] not in EXPECTED_REFUSALS]
    return {
        "meta": {"smoke": smoke, "batch": batch, "torch": torch.__version__,
                 "device": str(device), "backends": list(backends),
                 "ids": sorted({c[0] for c in cells}),
                 "train_cells": list(train_ids),
                 "thresholds": dict(DEFAULT_THRESHOLDS),
                 "gated_metrics": list(GATED_METRICS),
                 "ceilings": {"card": CARD,
                              "power_limit_watts": POWER_LIMIT_WATTS,
                              "peak_bf16_flops": PEAK_BF16_FLOPS,
                              "peak_f32_flops": PEAK_F32_FLOPS,
                              "hbm_bytes_per_s": HBM_BYTES_PER_S}},
        "rows": rows,
        "summary": {"cells": len(rows), "hosted": len(hosted),
                    "refused": len(rows) - len(hosted),
                    "unexpected_refusals": [f"{r['id']}×{r['backend']}: "
                                            f"{r['refusal']}"
                                            for r in unexpected]},
    }


def _key(row: Dict[str, Any]) -> Tuple[str, str]:
    return (row["id"], row["backend"])


def check(report: Dict[str, Any], baseline: Dict[str, Any],
          thresholds: Optional[Dict[str, float]] = None
          ) -> Tuple[List[str], List[str]]:
    """Diff a cost report against a baseline report: `(problems, notes)`.
    Problems: a gated metric regressed past its family's threshold, a
    baseline-hosted cell is missing or refused, or a cell's batch or env
    steps a program changed. Notes: improvements past the threshold and
    new cells."""
    problems: List[str] = []
    notes: List[str] = []
    new_rows = {_key(r): r for r in report["rows"]}
    base_rows = {_key(r): r for r in baseline["rows"]}
    base_dev = baseline.get("meta", {}).get("device")
    dev = report.get("meta", {}).get("device")
    if base_dev and dev and base_dev != dev:
        notes.append(f"device changed {base_dev} -> {dev}; the counts may "
                     "legitimately differ")
    for key, base in sorted(base_rows.items()):
        tag = f"{key[0]}×{key[1]}"
        new = new_rows.get(key)
        if new is None:
            problems.append(f"{tag}: cell missing from the new report "
                            "(id or backend dropped?)")
            continue
        if base["status"] == "refused":
            if new["status"] == "ok":
                notes.append(f"{tag}: newly hosted (was refused: "
                             f"{base['refusal']}) — regen the baseline to "
                             "start gating it")
            continue
        if new["status"] == "refused":
            problems.append(f"{tag}: was hosted in the baseline, now "
                            f"refused ({new['refusal']}: "
                            f"{new.get('refusal_msg', '')})")
            continue
        for dim in ("batch", "env_steps_per_program"):
            if base.get(dim) != new.get(dim):
                problems.append(f"{tag}: {dim} changed "
                                f"{base.get(dim)} -> {new.get(dim)}; "
                                "costs not comparable — regen the baseline")
                break
        else:
            fam = new.get("family") or base.get("family", "other")
            thr = threshold_for(fam, thresholds)
            for metric in GATED_METRICS:
                b, n = base.get(metric) or 0.0, new.get(metric) or 0.0
                if not b:
                    continue
                rel = (n - b) / b
                if rel > thr:
                    problems.append(
                        f"{tag}: {metric} regressed {rel:+.1%} "
                        f"({b:.4g} -> {n:.4g}; {fam} threshold {thr:.0%})")
                elif rel < -thr:
                    notes.append(
                        f"{tag}: {metric} improved {rel:+.1%} "
                        f"({b:.4g} -> {n:.4g}) — regen the baseline to "
                        "lock it in")
    for key in sorted(set(new_rows) - set(base_rows)):
        notes.append(f"{key[0]}×{key[1]}: new cell not in the baseline — "
                     "regen to start gating it")
    return problems, notes


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.cost",
        description="static cost model and regression gate")
    ap.add_argument("--smoke", action="store_true",
                    help="small batch; vmap and the kernel path only")
    ap.add_argument("--ids", default="",
                    help="comma-separated id subset (default: full registry)")
    ap.add_argument("--batch", type=int, default=0,
                    help="envs per pool (default: 4 smoke, 16 full)")
    ap.add_argument("--train", action=argparse.BooleanOptionalAction,
                    default=None, help="cost the train steps too")
    ap.add_argument("--device", default=None,
                    help="the device (default: the CUDA card)")
    ap.add_argument("--json", default="", metavar="PATH",
                    help="write the cost report as JSON")
    ap.add_argument("--check", default="", metavar="BASELINE",
                    help="diff against a baseline report; exit nonzero on "
                         "any regression past its threshold")
    args = ap.parse_args(argv)
    ids = [i.strip() for i in args.ids.split(",") if i.strip()] or None
    report = run(ids=ids, batch=args.batch or (4 if args.smoke else 16),
                 smoke=args.smoke, train=args.train, device=args.device,
                 progress=lambda r: print(json.dumps(
                     {k: r.get(k) for k in ("id", "backend", "status",
                                            "flops_per_step",
                                            "bytes_per_step",
                                            "refusal")}), flush=True))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
    s = report["summary"]
    print(f"repro_torch.analysis.cost: {s['cells']} cells "
          f"({s['hosted']} hosted, {s['refused']} refused)")
    rc = 1 if s["unexpected_refusals"] else 0
    for r in s["unexpected_refusals"]:
        print(f"  UNEXPECTED REFUSAL: {r}")
    if args.check:
        with open(args.check) as f:
            problems, notes = check(report, json.load(f))
        for n in notes:
            print(f"  note: {n}")
        for p in problems:
            print(f"  COST REGRESSION: {p}")
        rc = 1 if problems else rc
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
