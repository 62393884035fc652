"""Perf-iteration harness (port of `repro.launch.perf`): lay a cell out on
the production mesh under a named VARIANT of the tunable knobs and report
its per-device roofline terms.

Knobs (the JAX module's, with its defaults; `parse_variant`):
  remat            : none | dots | full          (compute <-> memory trade)
  ce_chunk         : loss-chunk length           (CE temp memory)
  q_chunk          : attention query chunk       (the attention backward's
                     recompute chunk here: the forward is the kernel)
  accum            : gradient-accumulation steps (collective amortisation)
  seq_shard_decode : shard decode cache seq over model axis when heads can't
                     be TP-sharded (collective <-> memory trade)
  dtype            : activation dtype
  mla_absorb       : weight-absorbed latent attention
  moe_ep_only      : experts EP over "model" only (no FSDP gathers of the
                     expert bank)
  moe_groups       : shard-local grouped MoE dispatch
  cache_bf16       : parsed and read by nothing, as in the JAX module
Each knob is passed as an argument (`TrainConfig`, `make_train_step`'s
`ce_chunk` and `q_chunk`, the config, the cache specs); the one global,
`sharding.rules._MOE_EP_ONLY`, is set for the cell and put back after it,
also when the cell raises.

Where the JAX module AOT-compiles the cell on 256 (512) forced host
devices and reads the HLO, the port runs the step once on the production
mesh as a described mesh: the fake process group at the mesh's size
(`launch/mesh.py::described`), this process its rank 0, every tensor
fake (`FakeTensorMode`: shapes only, no memory, no arithmetic). The params
and Adam state are laid out by the sharding rules (`reshard_state`), the
batch by `batch_specs`, and DTensor issues the step's collectives as it
would on the cards. The counts are one device's (rank 0's), from
`analysis/cost.py::counting`:
  - `flops_per_device`, `bytes_per_device`: the aten ops on the rank's
    local shards (FlopCounterMode's flops; operand and output bytes) plus
    the kernels' `cost` (the flash forward on the rank's (batch, heads)
    shard);
  - `collective_bytes_per_device`: the operand bytes of the
    `_c10d_functional` collectives DTensor issues, by kind, and "total"
    (the JAX module counts output bytes from the HLO);
  - `score_traffic_s`: the bytes through score-shaped tensors (f32,
    rank >= 4, last dim the kv length) that the plain attention moves and
    the flash kernel keeps on chip: here the attention backward's plain
    recompute (the forward is the kernel already), over HBM;
    `memory_s_flash` takes them off `memory_s`;
  - `temp_gib`: the peak, over the step, of the bytes of live storage the
    step made on the rank (its local shards' tensors, fake), counted by a
    dispatch mode of the port's own (`LiveBytes`; PyTorch's `MemTracker`
    counts a DTensor at its global size); the kernels' plain twins are not
    counted, as the kernels keep their work on chip; `args_gib`: the
    rank's shards of the params, Adam state and batch;
  - `compile_s`: the seconds the cell took to lay out, run and count (the
    JAX module's compile time stands there).
The ceilings are one NVIDIA H100 SXM5's at its 700 W limit
(`analysis/cost.py`): bf16 or f32 dense peak, HBM3 3.35 TB/s, and NVLink
4's 900 GB/s (the data sheet's) for the collectives. Measured on no card:
these are counts against the data sheet.

Every cell the registry runs (`configs/registry.py::cell_supported`) is
laid out on the mesh, as the JAX module's `compile_cell` lays it out:
train cells by the params', Adam state's and batch's rules; prefill cells
by the params' and batch's, their caches made inside on the mesh
(`lm.init_cache(mesh=)`); decode cells with their caches laid out by
`rules.serve_cache_specs` (the batch-1 `long_500k` cells' sequence, or a
recurrent state's K dim, over the data axes; under `seq_shard_decode` the
sequence over "model" where the heads are not), one token decoded at the
last position. A cell the registry skips (a pure-attention arch at
`long_500k`) reports FLOPs and bytes as the dry run does (the one-device
step on meta tensors, split evenly over the mesh), with null collective
bytes and the registry's reason.

Usage:
  python -m repro_torch.launch.perf --arch olmoe-1b-7b \\
      --shape train_4k --variant remat=dots,accum=4
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Dict, Iterator, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.cost import (CARD, HBM_BYTES_PER_S, PEAK_BF16_FLOPS,
                                       PEAK_F32_FLOPS, POWER_LIMIT_WATTS,
                                       counting, work_of)
from repro_torch.configs.base import ShapeConfig, shape_by_name
from repro_torch.configs.registry import (ARCH_IDS, cell_supported,
                                          get_config, input_specs)
from repro_torch.launch.mesh import Mesh, described, make_production_mesh
from repro_torch.sharding import rules

#: NVLink 4: one H100 SXM5's 900 GB/s (the data sheet's, both directions)
NVLINK_BYTES_PER_S = 900e9
GIB = 2 ** 30

_KNOB_DEFAULTS = {
    "remat": "full",
    "ce_chunk": 512,
    "q_chunk": 512,
    "accum": 1,
    "seq_shard_decode": 0,
    "dtype": "bfloat16",
    "mla_absorb": 0,        # weight-absorbed latent attention
    "moe_ep_only": 0,       # experts: EP over model only (no FSDP gathers)
    "moe_groups": 0,        # shard-local grouped MoE dispatch
    "cache_bf16": 1,        # parsed, read by nothing (as in the JAX module)
}

def parse_variant(s: str) -> Dict:
    knobs = dict(_KNOB_DEFAULTS)
    if s:
        for kv in s.split(","):
            k, v = kv.split("=")
            knobs[k] = v if k in ("remat", "dtype") else int(v)
    return knobs


def cell_config(arch: str, knobs: Dict, reduced: bool = False):
    """The arch's config with the knobs the JAX module replaces in it."""
    return dataclasses.replace(get_config(arch, reduced=reduced),
                               dtype=knobs["dtype"],
                               mla_absorb=bool(knobs["mla_absorb"]),
                               moe_groups=int(knobs["moe_groups"]))


class Cell(NamedTuple):
    """A cell laid out on a described mesh: fake DTensors (`opt` None for
    prefill and decode, `caches` None but for decode), and `run()`, its
    step once (train: `step(params, opt, batch)`; prefill: `lm.prefill`;
    decode: `lm.decode_step` at the last position)."""

    params: Any
    opt: Any
    batch: Dict[str, torch.Tensor]
    step: Any
    caches: Any = None


@contextlib.contextmanager
def build_cell(arch: str, shape: ShapeConfig, knobs: Dict,
               multi_pod: bool = False, *, mesh: Optional[Mesh] = None,
               reduced: bool = False) -> Iterator[Cell]:
    """The cell of `arch` at `shape` under `knobs` (the JAX module's
    `compile_cell`: train, prefill or decode), laid out on `mesh` (the
    production mesh by default) as a described mesh with fake tensors, for
    the block. The knobs go in as arguments; `moe_ep_only` sets the rules'
    one global, put back on exit."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import lm
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.train.trainer import (TrainConfig, make_optimizer,
                                           make_train_step)

    cfg = cell_config(arch, knobs, reduced)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    old = rules._MOE_EP_ONLY[0]
    rules.set_moe_ep_only(bool(knobs["moe_ep_only"]))
    try:
        with described(mesh) as laid, FakeTensorMode():
            params = lm.init_params(cfg, torch.Generator(), "cpu")
            batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                     for k, v in input_specs(cfg, shape).items()}
            if shape.kind == "train":
                tc = TrainConfig(remat=knobs["remat"],
                                 accum_steps=knobs["accum"])
                params, opt = reshard_state(
                    (params, make_optimizer(tc).init(params)), laid)
                step = make_train_step(cfg, tc, ce_chunk=knobs["ce_chunk"],
                                       q_chunk=knobs["q_chunk"])
                yield Cell(params, opt, batch, step)
            elif shape.kind == "prefill":
                yield Cell(reshard_state(params, laid), None, batch,
                           lambda p, o, b: lm.prefill(cfg, p, b,
                                                      shape.seq_len))
            else:
                b = shape.global_batch
                caches = lm.init_cache(cfg, b, shape.seq_len, "cpu", laid,
                                       bool(knobs["seq_shard_decode"]))
                yield Cell(reshard_state(params, laid), None, batch,
                           lambda p, o, bt: lm.decode_step(
                               cfg, p, caches, bt["tokens"],
                               shape.seq_len - 1), caches)
    finally:
        rules.set_moe_ep_only(old)


class LiveBytes(TorchDispatchMode):
    """The peak bytes of live storage made by the ops run inside (one
    rank's: DTensors are let through, their local ops counted; DTensor's
    shape propagation is not). Each new storage is held by a weak
    reference; freed ones are swept before a new peak is taken (so the peak
    is exact) and every 256 ops."""

    def __init__(self):
        super().__init__()
        self.live: Dict[int, Any] = {}
        self.total = self.peak = self.ops = 0

    def _sweep(self) -> None:
        for key in [k for k, (ref, _) in self.live.items() if ref.expired()]:
            self.total -= self.live.pop(key)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.multiprocessing.reductions import StorageWeakRef
        from torch.utils._pytree import tree_leaves

        from repro_torch.analysis.cost import _has_dtensor, _Propagating

        if _has_dtensor(args, kwargs):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if _Propagating.depth:
            return out
        for x in tree_leaves(out):
            if not isinstance(x, torch.Tensor):
                continue
            st = x.untyped_storage()
            old = self.live.get(st._cdata)
            if old is not None and not old[0].expired():
                continue
            if old is not None:
                self.total -= self.live.pop(st._cdata)[1]
            n = st.nbytes()
            if self.total + n > self.peak:
                self._sweep()
            self.live[st._cdata] = (StorageWeakRef(st), n)
            self.total += n
            self.peak = max(self.peak, self.total)
        self.ops += 1
        if self.ops % 256 == 0:
            self._sweep()
        return out


def _local_bytes(tree) -> int:
    from torch.utils._pytree import tree_leaves

    from repro_torch.kernels import is_dtensor

    return sum(y.numel() * y.element_size()
               for x in tree_leaves(tree) if isinstance(x, torch.Tensor)
               for y in [x.to_local() if is_dtensor(x) else x])


def sharded_counts(arch: str, shape: ShapeConfig, knobs: Dict,
                   multi_pod: bool = False, *, mesh: Optional[Mesh] = None,
                   reduced: bool = False) -> Dict[str, Any]:
    """One device's counts of the cell's step run on the mesh: flops,
    bytes, score bytes, collectives by kind, flash launches, peak temp and
    argument bytes (params, Adam state, batch and caches)."""
    from repro_torch.models.lm import place_batch

    with build_cell(arch, shape, knobs, multi_pod, mesh=mesh,
                    reduced=reduced) as cell:
        batch = place_batch(cell.batch, cell.params)
        args = _local_bytes((cell.params, cell.opt, batch, cell.caches))
        grad = torch.enable_grad() if shape.kind == "train" else \
            torch.no_grad()
        with counting(kv_len=shape.seq_len) as counted, LiveBytes() as live, \
                grad:
            cell.step(cell.params, cell.opt, batch)
    flops, nbytes = work_of(counted)
    return {"flops": flops, "bytes": nbytes,
            "score_bytes": counted["score_bytes"],
            "collectives": counted["collectives"],
            "flash_launches": counted.get("flash", {}).get("launches", 0),
            "temp_bytes": live.peak, "args_bytes": args}


def unsharded_counts(arch: str, shape: ShapeConfig, knobs: Dict,
                     multi_pod: bool = False, *, mesh: Optional[Mesh] = None,
                     reduced: bool = False) -> Dict[str, Any]:
    """The dry run's counts of the cell under `knobs`: the one-device step
    on meta tensors split evenly over the mesh, the state's bytes by the
    sharding rules."""
    from repro_torch.launch import dryrun
    from repro_torch.train.trainer import TrainConfig

    cfg = cell_config(arch, knobs, reduced)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    tc = TrainConfig(remat=knobs["remat"], accum_steps=knobs["accum"])
    old = rules._MOE_EP_ONLY[0]
    rules.set_moe_ep_only(bool(knobs["moe_ep_only"]))
    try:
        state = dryrun.build_cell(arch, shape, mesh, cfg=cfg, tc=tc,
                                  seq_shard_decode=bool(
                                      knobs["seq_shard_decode"]))
        got = dryrun.step_flops(arch, shape, state, cfg=cfg, tc=tc,
                                ce_chunk=knobs["ce_chunk"],
                                q_chunk=knobs["q_chunk"])
    finally:
        rules.set_moe_ep_only(old)
    n = mesh.size
    return {"flops": got["flops"] / n, "bytes": got["bytes"] / n,
            "score_bytes": got["score_bytes"] / n, "collectives": None,
            "flash_launches": got["flash_launches"], "temp_bytes": None,
            "args_bytes": sum(dryrun.sharded_bytes(t, s, mesh)
                              for t, s in state.values())}


def measure(arch: str, shape_name: str, variant: str = "",
            multi_pod: bool = False, *, mesh: Optional[Mesh] = None,
            reduced: bool = False) -> Dict[str, Any]:
    """The JAX module's report of one cell under one variant, for one
    device of `mesh` (the production mesh by default)."""
    knobs = parse_variant(variant)
    shape = shape_by_name(shape_name)
    why = cell_supported(arch, shape_name)
    t0 = time.perf_counter()
    run = unsharded_counts if why else sharded_counts
    got = run(arch, shape, knobs, multi_pod, mesh=mesh, reduced=reduced)
    dt = time.perf_counter() - t0
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    peak = PEAK_BF16_FLOPS if knobs["dtype"] == "bfloat16" else PEAK_F32_FLOPS
    coll = got["collectives"]
    res = {
        "arch": arch, "shape": shape_name, "variant": variant or "baseline",
        "knobs": knobs, "mesh": dict(mesh.shape), "sharded": why is None,
        "compile_s": round(dt, 1),
        "flops_per_device": got["flops"],
        "bytes_per_device": got["bytes"],
        "collective_bytes_per_device": coll,
        "compute_s": got["flops"] / peak,
        "memory_s": got["bytes"] / HBM_BYTES_PER_S,
        "collective_s": coll["total"] / NVLINK_BYTES_PER_S if coll else None,
        "score_traffic_s": got["score_bytes"] / HBM_BYTES_PER_S,
        "memory_s_flash": (got["bytes"] - got["score_bytes"]) / HBM_BYTES_PER_S,
        "flash_launches": got["flash_launches"],
        "temp_gib": (got["temp_bytes"] / GIB
                     if got["temp_bytes"] is not None else None),
        "args_gib": got["args_bytes"] / GIB,
        "ceilings": {"card": CARD, "power_limit_watts": POWER_LIMIT_WATTS,
                     "peak_flops": peak, "hbm_bytes_per_s": HBM_BYTES_PER_S,
                     "nvlink_bytes_per_s": NVLINK_BYTES_PER_S},
    }
    res["null_reasons"] = {k: why for k, v in res.items() if v is None}
    terms = [res["compute_s"], res["memory_s"], res["collective_s"] or 0.0]
    res["bound_s"] = max(terms)
    res["bound_s_flash"] = max(terms[0], res["memory_s_flash"], terms[2])
    return res


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.perf")
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    res = measure(args.arch, args.shape, args.variant, args.multi_pod)
    print(json.dumps(res, indent=2))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
