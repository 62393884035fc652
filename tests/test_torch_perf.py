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
- Every cell the registry runs is laid out (train, prefill, decode): the
  reduced yi-6b's prefill and decode FLOPs a device times the 4 ranks are
  the dry run's one-device count; `seq_shard_decode=1` takes the reduced
  yi-6b's decode cache off its "model" replicas on a (2, 4) mesh. A cell
  the registry skips gives null collective bytes and collective time, with
  the registry's reason, and the CLI prints the JAX module's keys.
"""
import contextlib
import io
import json
import os

import pytest
import torch

from repro_torch.configs.base import shape_by_name
from repro_torch.configs.registry import cell_supported, get_config
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
    """Every cell the registry runs is laid out (MLA's train cell here);
    only a cell the registry skips (a pure-attention arch at long_500k)
    gives null collective terms, with the registry's reason. The CLI, on
    the production mesh, prints the JAX module's keys for a decode cell
    laid out with its caches."""
    res = perf.measure("minicpm3-4b", "train_4k", mesh=MESH, reduced=True)
    assert res["sharded"] is True and res["null_reasons"] == {}
    assert res["collective_bytes_per_device"]["total"] > 0
    assert res["flops_per_device"] > 0 and res["args_gib"] > 0
    skipped = perf.measure("yi-6b", "long_500k", mesh=MESH, reduced=True)
    assert skipped["sharded"] is False
    assert skipped["collective_bytes_per_device"] is None
    assert set(skipped["null_reasons"]) == {"collective_bytes_per_device",
                                            "collective_s", "temp_gib"}
    why = cell_supported("yi-6b", "long_500k")
    assert why and all(v == why for v in skipped["null_reasons"].values())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert perf.main(["--arch", "whisper-base", "--shape",
                          "decode_32k"]) == 0
    cli = json.loads(out.getvalue())
    assert set(JAX_KEYS) <= set(cli)
    assert cli["mesh"] == {"data": 16, "model": 16}
    assert cli["sharded"] and cli["null_reasons"] == {}
    assert cli["collective_bytes_per_device"]["total"] > 0
    assert cli["ceilings"]["nvlink_bytes_per_s"] == perf.NVLINK_BYTES_PER_S


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_serving_flops_split_evenly(shape):
    """A prefill or decode cell's per-device FLOPs times the mesh's size
    are its one-device count (the dry run's, on meta tensors) on the
    reduced dense model: every product, and attention, is split over the
    batch and the heads; the caches are laid out (decode: by the rules'
    cache specs), and the step issues collectives."""
    cell = shape_by_name(shape)
    got = perf.sharded_counts("yi-6b", cell, perf.parse_variant(""),
                              mesh=MESH, reduced=True)
    want = perf.unsharded_counts("yi-6b", cell, perf.parse_variant(""),
                                 mesh=MESH, reduced=True)
    assert got["flops"] * MESH.size == want["flops"] * MESH.size > 0
    assert got["collectives"]["total"] > 0
    assert got["flash_launches"] == get_config("yi-6b", reduced=True).num_layers


def test_seq_shard_decode_moves_cache_bytes_off_the_model_replicas():
    """Where the KV heads do not divide "model" (the reduced yi-6b's 2 over
    4), its decode cache is replicated over "model"; `seq_shard_decode=1`
    puts the sequence there instead: a quarter of the cache's bytes a
    device, and the one-token query (gathered over "model") attends over
    each rank's keys, the ranks' log-sum-exps merged by all-reduces."""
    mesh = Mesh({"data": 2, "model": 4})
    cell = shape_by_name("decode_32k")
    cfg = get_config("yi-6b", reduced=True)
    base = perf.sharded_counts("yi-6b", cell, perf.parse_variant(""),
                               mesh=mesh, reduced=True)
    split = perf.sharded_counts("yi-6b", cell,
                                perf.parse_variant("seq_shard_decode=1"),
                                mesh=mesh, reduced=True)
    kv = 2 * cfg.num_layers * cell.global_batch * cfg.num_kv_heads \
        * cell.seq_len * cfg.hd * 2 // mesh.shape["data"]   # bf16
    assert base["args_bytes"] - split["args_bytes"] == kv - kv // 4
    assert split["collectives"]["all-reduce"] > base["collectives"]["all-reduce"]
    # a device's attention: its query head over every key, or every query
    # head over its quarter of the keys
    assert split["flops"] == base["flops"]


def test_recurrent_train_cell_where_heads_do_not_divide_model():
    """The production xLSTM's 4 heads do not divide a "model" of 16: the
    mLSTM's q, k and v stay replicated there while its x and z
    projections shard over "model", and the step's backward must bring the
    output's gradient back whole before cutting it into heads. The reduced
    xLSTM (4 heads) on a described (1, 8) mesh takes the same layout."""
    from repro_torch.configs.base import ShapeConfig

    got = perf.sharded_counts("xlstm-350m", ShapeConfig("t", "train", 32, 8),
                              perf.parse_variant(""),
                              mesh=Mesh({"data": 1, "model": 8}), reduced=True)
    assert got["flops"] > 0 and got["collectives"]["total"] > 0


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
