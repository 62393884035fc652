"""Dry run: every (arch × shape × mesh) cell's state laid out by the
sharding rules, with no memory (port of `repro.launch.dryrun`).

The JAX dry run AOT-compiles each cell's step on the production mesh
against ShapeDtypeStruct stand-ins and reads the compiled artifact. The
port compiles nothing: a cell's params are drawn under `FakeTensorMode`
(shapes and dtypes only), its optimizer state, caches and inputs are
tensors on the "meta" device, and the report counts

  - per-device bytes of the params, optimizer state, caches and inputs
    under the sharding rules (`sharding/rules.py`) on the production mesh
    (`launch/mesh.py`), and whether they fit one NVIDIA H100's 80 GB (the
    state only: activations are not counted); the whole cell's bytes and
    whether they fit one card;
  - with `flops=True`, the step's FLOPs: `FlopCounterMode` over the aten
    ops of the step run on meta tensors, plus the flash kernel's `cost`
    for each attention call (analysis/cost.py::counting); per device is
    the even split over the mesh. A step that cannot run on meta tensors
    gives null, with the reason;
  - with `flops=True`, collective bytes per device: the operand bytes of
    the collectives the cell's step issues on the production mesh as a
    described mesh (fake process group, fake tensors; launch/perf.py's
    sharded run of every train, prefill and decode cell), by kind.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --no-flops
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import Any, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.configs.base import SHAPES, ShapeConfig, shape_by_name
from repro_torch.configs.registry import (ARCH_IDS, cell_supported,
                                          get_config, input_specs)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import rules

#: one NVIDIA H100 SXM5's device memory (data sheet)
H100_BYTES = 80e9
META = torch.device("meta")


def meta_params(cfg) -> Any:
    """The model's params as meta tensors: drawn under FakeTensorMode (no
    memory, no numbers), then given the meta device."""
    from repro_torch.models import lm

    with FakeTensorMode():
        fake = lm.init_params(cfg, torch.Generator(), "cpu")
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device=META), fake)


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def sharded_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of `tree` laid out by `specs` (one per leaf)."""
    leaves = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
    spec_leaves = tree_leaves(specs, is_leaf=rules.is_spec)
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} leaves, {len(spec_leaves)} specs")
    return sum(math.prod(rules.local_shape(x.shape, s, mesh))
               * x.element_size() for x, s in zip(leaves, spec_leaves))


#: the dry run's train step: the JAX dry run's remat, no accumulation
DRY_RUN_TRAIN = dict(remat="full", accum_steps=1)


def build_cell(arch: str, shape: ShapeConfig, mesh, *, cfg=None, tc=None,
               seq_shard_decode: bool = False) -> Dict[str, Any]:
    """{name: (tree, specs)} of one cell's state, every tensor on meta;
    `cfg` and `tc` default to the arch's config and `DRY_RUN_TRAIN`, and
    a decode cell's caches are laid out as lm.init_cache lays them out
    on a mesh (`rules.serve_cache_specs`; `seq_shard_decode` puts their
    sequence over "model" where their heads are not, launch/perf.py's
    knob)."""
    from repro_torch.models import lm
    from repro_torch.train.trainer import TrainConfig, make_optimizer

    cfg = cfg or get_config(arch)
    params = meta_params(cfg)
    state = {"params": (params, rules.param_specs(params, mesh))}
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        opt = make_optimizer(tc or TrainConfig(**DRY_RUN_TRAIN)).init(params)
        state["opt"] = (opt, rules.opt_specs(opt, params, mesh))
        state["batch"] = (batch, rules.batch_specs(mesh, batch))
        return state
    if shape.kind == "prefill":
        state["batch"] = (batch, rules.batch_specs(mesh, batch))
        return state
    b = shape.global_batch
    caches = lm.init_cache(cfg, b, shape.seq_len, META)
    state["caches"] = (caches, rules.serve_cache_specs(mesh, caches, b,
                                                       seq_shard_decode))
    state["batch"] = (batch, rules.batch_specs(mesh, batch))
    return state


def step_flops(arch: str, shape: ShapeConfig, state, *, cfg=None, tc=None,
               ce_chunk: int = 512, q_chunk: int = 512) -> Dict[str, Any]:
    """FLOPs (and bytes) of the cell's step on meta tensors: aten ops plus
    the flash cost of each attention call."""
    from repro_torch.analysis.cost import counting, work_of
    from repro_torch.models import lm
    from repro_torch.train.trainer import TrainConfig, make_train_step

    cfg = cfg or get_config(arch)
    params = state["params"][0]
    batch = state["batch"][0]
    with counting(kv_len=shape.seq_len) as counted:
        if shape.kind == "train":
            step = make_train_step(cfg, tc or TrainConfig(**DRY_RUN_TRAIN),
                                   ce_chunk=ce_chunk, q_chunk=q_chunk)
            step(params, state["opt"][0], batch)
        elif shape.kind == "prefill":
            with torch.no_grad():
                lm.prefill(cfg, params, batch, shape.seq_len)
        else:
            with torch.no_grad():
                lm.decode_step(cfg, params, state["caches"][0],
                               batch["tokens"], shape.seq_len - 1)
    flash = counted.get("flash", {})
    return {"flops": counted["aten_flops"] + flash.get("flops", 0),
            "aten_flops": counted["aten_flops"],
            "flash_flops": flash.get("flops", 0),
            "flash_launches": flash.get("launches", 0),
            "bytes": work_of(counted)[1],
            "score_bytes": counted["score_bytes"]}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             flops: bool = True) -> Dict[str, Any]:
    shape = shape_by_name(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    skip = cell_supported(arch, shape_name)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": skip}
    cfg = get_config(arch)
    state = build_cell(arch, shape, mesh)
    per_device = {k: sharded_bytes(t, s, mesh) for k, (t, s) in state.items()}
    whole = {k: tree_bytes(t) for k, (t, _) in state.items()}
    out: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "ok",
        "kind": shape.kind, "chips": mesh.size, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "params": sum(x.numel() for x in tree_leaves(state["params"][0])),
        "bytes_per_device": per_device,
        "bytes_per_device_total": sum(per_device.values()),
        "fits_h100_80gb": sum(per_device.values()) <= H100_BYTES,
        "bytes_whole": whole, "bytes_whole_total": sum(whole.values()),
        "whole_fits_one_h100_80gb": sum(whole.values()) <= H100_BYTES,
        "memory_counted": "params, optimizer state, caches and inputs; "
                          "activations not counted",
        "collective_bytes_per_device": None,
        "active_params": cfg.active_param_count(),
    }
    if flops:
        try:
            got = step_flops(arch, shape, state)
        except (RuntimeError, NotImplementedError, ValueError,
                TypeError) as e:
            out.update(flops=None, flops_error=f"{type(e).__name__}: "
                       f"{str(e).splitlines()[0][:200] if str(e) else ''}")
        else:
            got = {k: got[k] for k in ("flops", "aten_flops", "flash_flops",
                                       "flash_launches")}
            out.update(got, flops_per_device=got["flops"] / mesh.size)
    out.update(collectives(arch, shape, multi_pod, flops))
    return out


def collectives(arch: str, shape: ShapeConfig, multi_pod: bool,
                run: bool = True, *, mesh=None,
                reduced: bool = False) -> Dict[str, Any]:
    """{"collective_bytes_per_device": by kind and "total", or None and
    "collective_bytes_why"}: launch/perf.py's sharded run of the cell at
    its baseline knobs, where the registry runs the cell and `run`."""
    from repro_torch.launch import perf

    knobs = perf.parse_variant("")
    why = cell_supported(arch, shape.name)
    if why is None and not run:
        why = "not counted: the step was not run (flops=False)"
    if why is not None:
        return {"collective_bytes_per_device": None,
                "collective_bytes_why": why}
    got = perf.sharded_counts(arch, shape, knobs, multi_pod, mesh=mesh,
                              reduced=reduced)
    return {"collective_bytes_per_device": got["collectives"]}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--flops", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="count the step's FLOPs on meta tensors")
    ap.add_argument("--out", default="",
                    help="also write one JSON file a cell into this directory")
    args = ap.parse_args(argv)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(a, s.name) for a in ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape required unless --all")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    for arch, shape_name in cells:
        for multi_pod in meshes:
            res = run_cell(arch, shape_name, multi_pod, flops=args.flops)
            print(json.dumps(res), flush=True)
            if args.out:
                tag = f"{arch}__{shape_name}__{'multi' if multi_pod else 'single'}"
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(res, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
