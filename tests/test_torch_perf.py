"""The port's `launch/perf.py` against the JAX package's knobs and the
port's dry run, on the CPU.

- `parse_variant` equals `repro.launch.perf.parse_variant` on a list of
  variant strings (the JAX module is imported after JAX's backend is up,
  and its XLA_FLAGS default taken back out, so the worker keeps its
  devices and its subprocesses their environment).
- The reduced yi-6b and olmoe-1b-7b train cells on a described (2, 2)
  mesh (the fake process group, fake tensors): one device's FLOPs times
  the 4 ranks are the dry run's one-device meta count, exactly for the
  dense model (every product is split) and plus the router's work on the
  "model" ranks (3 more copies of it: the router is replicated) for the
  MoE model with its groups over the data axis; collective bytes > 0;
  `moe_ep_only=1` moves fewer all-gather bytes than the baseline (no FSDP
  gathers of the expert bank); `remat=full` counts at least the FLOPs of
  `remat=none`; `_MOE_EP_ONLY` is back after a variant that raised.
- A cell that does not run sharded gives null collective bytes and
  collective time, each with the ROADMAP item that adds them, and the CLI
  prints the JAX module's keys.
"""
import contextlib
import io
import json
import os

import pytest
import torch

from repro_torch.configs.base import shape_by_name
from repro_torch.launch import perf
from repro_torch.launch.mesh import Mesh
from repro_torch.sharding import rules


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MESH = Mesh({"data": 2, "model": 2})
TRAIN = shape_by_name("train_4k")
#: the keys of the JAX module's report
JAX_KEYS = ("arch", "shape", "variant", "knobs", "compile_s",
            "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "compute_s", "memory_s",
            "collective_s", "score_traffic_s", "memory_s_flash", "bound_s",
            "bound_s_flash", "temp_gib", "args_gib")
VARIANTS = ["", "remat=dots", "remat=none,accum=4", "moe_ep_only=1",
            "moe_groups=16,ce_chunk=256", "q_chunk=1024,dtype=float32",
            "seq_shard_decode=1,cache_bf16=0", "mla_absorb=1,remat=full"]


def test_parse_variant_equals_jax():
    import jax

    jax.devices()                       # the backend is up first
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import perf as jax_perf
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    assert perf._KNOB_DEFAULTS == jax_perf._KNOB_DEFAULTS
    for v in VARIANTS:
        assert perf.parse_variant(v) == jax_perf.parse_variant(v), v


def _sharded(arch, variant=""):
    return perf.sharded_counts(arch, TRAIN, perf.parse_variant(variant),
                               mesh=MESH, reduced=True)


def _meta(arch, variant=""):
    """The dry run's one-device FLOPs of the whole step (unsharded_counts
    splits them evenly over the mesh)."""
    return perf.unsharded_counts(arch, TRAIN, perf.parse_variant(variant),
                                 mesh=MESH, reduced=True)["flops"] * MESH.size


def test_dense_flops_split_evenly_and_remat_costs_flops():
    full, none = _sharded("yi-6b"), _sharded("yi-6b", "remat=none")
    assert full["flops"] * MESH.size == _meta("yi-6b")
    assert none["flops"] * MESH.size == _meta("yi-6b", "remat=none")
    assert full["flops"] >= none["flops"]
    assert full["collectives"]["total"] > 0
    assert full["collectives"]["all-reduce"] > 0
    # the forward and its "full" recompute each launch the kernel a layer
    assert (full["flash_launches"], none["flash_launches"]) == (4, 2)
    assert full["args_bytes"] > 0 and full["temp_bytes"] > 0


def test_moe_flops_add_only_the_replicated_router():
    got = _sharded("olmoe-1b-7b", "moe_groups=2")
    want = _meta("olmoe-1b-7b", "moe_groups=2")
    cfg = perf.cell_config("olmoe-1b-7b", perf.parse_variant(""), True)
    tokens = TRAIN.global_batch * TRAIN.seq_len
    router = 2 * tokens * cfg.d_model * cfg.num_experts
    # forward, its recompute, and the backward's two products, a layer;
    # each "model" rank routes every token of its data shard
    copies = MESH.shape["model"] - 1
    assert got["flops"] * MESH.size - want == copies * 4 * router * cfg.num_layers
    assert got["collectives"]["total"] > 0


def test_moe_ep_only_moves_fewer_all_gather_bytes_and_is_restored():
    base = _sharded("olmoe-1b-7b")
    ep = _sharded("olmoe-1b-7b", "moe_ep_only=1")
    assert ep["collectives"]["all-gather"] < base["collectives"]["all-gather"]
    assert rules._MOE_EP_ONLY[0] is False
    with pytest.raises(ValueError, match="remat"):
        _sharded("olmoe-1b-7b", "moe_ep_only=1,remat=sometimes")
    assert rules._MOE_EP_ONLY[0] is False
    assert not torch.distributed.is_initialized()


def test_unsharded_cells_say_why_and_the_cli_prints_jax_keys():
    res = perf.measure("minicpm3-4b", "train_4k", mesh=MESH, reduced=True)
    assert res["sharded"] is False
    assert res["collective_bytes_per_device"] is None
    assert set(res["null_reasons"]) == {"collective_bytes_per_device",
                                        "collective_s", "temp_gib"}
    assert all("ROADMAP A17" in why for why in res["null_reasons"].values())
    assert res["flops_per_device"] > 0 and res["args_gib"] > 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert perf.main(["--arch", "whisper-base", "--shape",
                          "decode_32k"]) == 0
    cli = json.loads(out.getvalue())
    assert set(JAX_KEYS) <= set(cli)
    assert cli["mesh"] == {"data": 16, "model": 16}
    assert "decode" in cli["null_reasons"]["collective_bytes_per_device"]
    assert cli["ceilings"]["nvlink_bytes_per_s"] == perf.NVLINK_BYTES_PER_S


def test_sharded_report_has_every_term():
    res = perf.measure("yi-6b", "train_4k", "remat=dots", mesh=MESH,
                       reduced=True)
    assert res["sharded"] and res["null_reasons"] == {}
    assert set(JAX_KEYS) <= set(res)
    coll = res["collective_bytes_per_device"]
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    assert res["collective_s"] == coll["total"] / perf.NVLINK_BYTES_PER_S
    assert res["bound_s"] == max(res["compute_s"], res["memory_s"],
                                 res["collective_s"])
    assert 0 < res["score_traffic_s"] < res["memory_s"]
    assert res["memory_s_flash"] < res["memory_s"]
