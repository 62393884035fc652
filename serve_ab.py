#!/usr/bin/env python3
"""Time chip_smoke.py's serving phases of several checkouts on one GPU,
each run in a process of its own, in the order given, then in reverse.

    python3 serve_ab.py DIR [DIR ...] [--phases lm,mla,whisper] [--log FILE]

from any directory, on a machine with a CUDA card and the CUDA toolkit.
Each DIR is the root of a checkout (`git archive <commit>` unpacked will
do): a run starts python in DIR with DIR/src first on the path, imports
DIR's chip_smoke.py, runs its phases device and build (the kernels built
from DIR's sources into DIR's own build directory), then the phases named,
as chip_smoke.py's main runs them. The phases print their JSON lines as
they do there; `--log` keeps every run's output in FILE.

One JSON line a run, then one with each checkout's runs side by side:
phase lm's Yi-6B serving (`serve`: tokens/s, median decode tick ms, time
to first token), phase mla's MiniCPM3-4B run (`run`: decode step ms,
tokens/s), phase whisper's (`run`: decode step ms, prefill s), each on the
host clock as the phase measures it, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

#: what a run executes in DIR (argv[1]: the phases, comma-separated)
RUN = """
import sys
import torch
import chip_smoke as C
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
C.phase_device(torch)
C.phase_build()
device = torch.device("cuda")
for name in sys.argv[1].split(","):
    getattr(C, "phase_" + name)(torch, device)
"""

#: (phase, key of its result, fields kept)
FIELDS = (("lm", "serve", ("tokens_per_s", "decode_tick_ms_median",
                           "ttft_s_median", "seconds")),
          ("mla", "run", ("decode_step_ms", "tokens_per_s", "prefill_s")),
          ("whisper", "run", ("decode_step_ms", "prefill_s", "encode_s")))


def run(tree: Path, phases: str, log) -> dict:
    """One process over `tree`: {"tree", "card", phase: {field: value}}."""
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    proc = subprocess.run([sys.executable, "-c", RUN, phases], cwd=tree,
                          env=env, capture_output=True, text=True,
                          timeout=1200)
    if log is not None:
        log.write(f"=== {tree} rc={proc.returncode}\n{proc.stdout}\n"
                  f"--- stderr\n{proc.stderr[-20000:]}\n")
        log.flush()
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit(f"{tree}: exit {proc.returncode}")
    out = {"tree": str(tree)}
    for line in proc.stdout.splitlines():
        if not line.startswith("{"):
            continue
        rec = json.loads(line)
        if rec.get("phase") == "device":
            out["card"] = rec.get("nvidia_smi")
        for phase, key, keep in FIELDS:
            if rec.get("phase") == phase and key in rec:
                out[phase] = {k: rec[key].get(k) for k in keep}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--phases", default="lm,mla,whisper")
    ap.add_argument("--log", type=Path)
    args = ap.parse_args()
    trees = [t.resolve() for t in args.trees]
    log = open(args.log, "w") if args.log else None
    runs = []
    try:
        for tree in trees + trees[::-1]:
            runs.append(run(tree, args.phases, log))
            print(json.dumps(runs[-1]), flush=True)
    finally:
        if log is not None:
            log.close()
    print(json.dumps({"by_tree": {str(t): [r for r in runs
                                           if r["tree"] == str(t)]
                                  for t in trees}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
