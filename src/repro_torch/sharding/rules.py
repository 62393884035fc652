"""Logical-axis sharding rules: per-leaf axis names for parameters,
optimizer state, batches and caches (port of `repro.sharding.rules`).

Strategy (the JAX package's, MaxText-style TP × FSDP):
  - tensor-parallel axis "model": attention heads, MLP hidden, vocab, MoE
    experts;
  - FSDP axis "data": the non-TP dim of each weight, so optimizer and param
    memory scale down with the data axis (ZeRO-3);
  - multi-pod axis "pod": pure data parallelism, parameters replicated
    across pods;
  - batch dims over ("pod", "data"); with batch 1 (long_500k) the KV cache's
    sequence dim takes them instead.

The rules are pure functions of leaf names, paths and shapes, so they
apply to every architecture's tree. A spec is a tuple with one entry per
dim of its leaf: None (replicated), an axis name, or a tuple of axis names
(what `jax.sharding.PartitionSpec` holds). A mesh is anything with
`axis_names` and a `shape` mapping axis -> size (`launch/mesh.py::Mesh`,
JAX's `AbstractMesh`, or a `torch.distributed` `DeviceMesh` with named
dims).

On a `DeviceMesh` a spec becomes DTensor placements, one per mesh dim
(`to_placements`): `Shard(d)` on each mesh dim that shards tensor dim d,
`Replicate()` elsewhere. `to_shardings` pairs a spec tree with its mesh as
`Sharding`s (JAX's `NamedSharding`), which `runtime/elastic.py::
reshard_state` and `CheckpointManager.restore(shardings=)` lay leaves out
by. `shard_hint` is the JAX package's activation pin: a redistribute of a
DTensor to the cleaned spec, a no-op on a plain tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

from torch.utils._pytree import (MappingKey, SequenceKey, GetAttrKey,
                                 tree_flatten, tree_flatten_with_path,
                                 tree_map, tree_unflatten)

from repro_torch.kernels import is_dtensor

Pytree = Any
Spec = Tuple[Any, ...]

BATCH_AXES = ("pod", "data")


def _names(mesh) -> Tuple[str, ...]:
    """A mesh's axis names: `axis_names`, or a `DeviceMesh`'s dim names."""
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in BATCH_AXES if a in _names(mesh))


def _entry(axes: Tuple[str, ...]):
    """A spec entry of several axes: one axis stands as its name (as a
    PartitionSpec holds it)."""
    return axes[0] if len(axes) == 1 else axes


def fsdp_axis(mesh):
    return "data" if "data" in _names(mesh) else None


def tp_axis(mesh):
    return "model" if "model" in _names(mesh) else None


# Shard MoE experts over model only (replicate over data): per-device
# expert memory traded for no per-layer FSDP gathers of the expert bank.
_MOE_EP_ONLY = [False]


def set_moe_ep_only(value: bool) -> None:
    _MOE_EP_ONLY[0] = bool(value)


# (path substring, leaf name) -> spec for the LAST len(spec) dims.
# First match wins; missing leading dims are padded with None.
_RULES = (
    # embeddings / head
    ("", "embed", ("model", "data")),          # (V, d): TP on vocab, FSDP on d
    ("", "lm_head", ("data", "model")),
    # MoE (match before generic w_in/w_out)
    ("moe", "router", (None, None)),
    ("moe", "w_in", ("model", "data", None)),   # (E, d, 2ff): EP + FSDP
    ("moe", "w_out", ("model", None, "data")),
    # attention
    ("", "wq", ("data", "model")),
    ("", "wk", ("data", "model")),
    ("", "wv", ("data", "model")),
    ("", "wo", ("model", "data")),
    # MLA
    ("", "w_dq", ("data", None)),
    ("", "w_uq", (None, "model")),
    ("", "w_dkv", ("data", None)),
    ("", "w_ukv", (None, "model")),
    # dense FFN
    ("", "w_in", ("data", "model")),
    ("", "w_out", ("model", "data")),
    ("", "mlp_in", ("data", "model")),
    ("", "mlp_out", ("model", "data")),
    # ssm cells
    ("cell", "w_x", ("data", "model")),
    ("cell", "w_z", ("data", "model")),
    ("cell", "w_q", (None, "model")),
    ("cell", "w_k", (None, "model")),
    ("cell", "w_g", ("data", None)),
    ("cell", "w_down", ("model", "data")),
    ("cell", "conv_w", (None, None)),
    ("cell", "r", (None, None, None)),
    ("cell", "o_scale", ("model",)),
    ("cell", "w", ("data", None)),              # slstm input proj
)


def _sizes(mesh) -> dict:
    """{axis name: size} of a described mesh or a `DeviceMesh`."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return shape
    return dict(zip(_names(mesh), shape))


def _size(mesh, axis: str) -> int:
    return int(_sizes(mesh)[axis])


def _spec_for(path: str, name: str, shape, mesh) -> Spec:
    ndim = len(shape)
    axes_avail = set(_names(mesh))
    rules = _RULES
    if _MOE_EP_ONLY[0]:
        rules = (("moe", "w_in", ("model", None, None)),
                 ("moe", "w_out", ("model", None, None))) + _RULES
    for substr, leaf, spec in rules:
        if substr in path and name == leaf and ndim >= len(spec):
            spec = tuple(a if a in axes_avail else None for a in spec)
            # drop axes that do not divide the dim evenly
            dims = shape[ndim - len(spec):]
            cleaned = tuple(
                a if a is not None and dims[i] % _size(mesh, a) == 0 else None
                for i, a in enumerate(spec))
            return (None,) * (ndim - len(cleaned)) + cleaned
    return (None,) * ndim  # replicate (norm scales, biases, gates)


def _path_str(path) -> str:
    parts = []
    for p in path:
        if isinstance(p, MappingKey):
            parts.append(str(p.key))
        elif isinstance(p, SequenceKey):
            parts.append(str(p.idx))
        elif isinstance(p, GetAttrKey):
            parts.append(str(p.name))
        else:
            parts.append(str(p))
    return "/".join(parts)


def _map_with_path(fn, tree):
    leaves, spec = tree_flatten_with_path(tree)
    return tree_unflatten([fn(_path_str(path), x) for path, x in leaves], spec)


def param_specs(params: Pytree, mesh) -> Pytree:
    """The spec of every parameter leaf, in the params' structure."""
    return _map_with_path(
        lambda ps, x: _spec_for(ps, ps.rsplit("/", 1)[-1], tuple(x.shape),
                                mesh), params)


def opt_specs(opt_state, params: Pytree, mesh):
    """Adam's mu and nu shard exactly like the params; the step count
    replicates."""
    from repro_torch.train.optim import AdamState

    pspecs = param_specs(params, mesh)
    same = lambda: tree_map(lambda s: s, pspecs)
    return AdamState(step=(), mu=same(), nu=same())


def batch_specs(mesh, batch_example: Pytree,
                batch_divisible: bool = True) -> Pytree:
    """Dim 0 (batch) of every array over (pod, data) when divisible."""
    da = data_axes(mesh)
    n = math.prod(_size(mesh, a) for a in da) if da else 1

    def spec(leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        if batch_divisible and shape[0] % n == 0 and shape[0] >= n:
            return (_entry(da),) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)

    return tree_map(spec, batch_example)


def cache_specs(mesh, caches: Pytree, batch: int, seq_sharded: bool) -> Pytree:
    """KV caches: (rep, B, H, S, hd) -> heads on model; B, or S where
    `seq_sharded` (batch 1), on (pod, data). SSM states have no sequence
    dim and shard heads over model only."""
    da = data_axes(mesh)
    n = math.prod(_size(mesh, a) for a in da) if da else 1
    tp = tp_axis(mesh)
    tp_n = _size(mesh, tp) if tp else 1

    def spec(leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd == 0:
            return ()
        dims = [None] * nd
        # canonical layouts: (rep,B,H,S,hd) attn | (rep,B,H,K,V) ssm |
        # (rep,B,S,r) mla | (rep,B,W,C) conv
        if nd >= 4:
            # dim 2 is heads for attn/ssm caches (<= 512) but seq for the
            # MLA latent cache (>= 1k): only genuine head dims go on TP
            if tp and shape[2] % tp_n == 0 and shape[2] <= 512:
                dims[2] = tp
            if seq_sharded and nd >= 5 and shape[3] % n == 0 and shape[3] > 1:
                dims[3] = _entry(da)
            elif not seq_sharded and shape[1] % n == 0 and shape[1] >= n:
                dims[1] = _entry(da)
        elif nd >= 2:
            if not seq_sharded and shape[1] % n == 0 and shape[1] >= n:
                dims[1] = _entry(da)
        return tuple(dims)

    return tree_map(spec, caches)


#: cache leaves whose dim 2 is the sequence, not heads: MLA's latent and
#: shared rotary key (B, S, r) stacked over layers
_SEQ_DIM2_LEAVES = ("c_kv", "k_rope")


def seq_shard_over_model(cspec, caches, mesh):
    """`cspec` with a decode KV cache's sequence dim over "model" where its
    heads are not TP-sharded (the JAX `launch/perf.py`'s
    `_seq_shard_over_model`: leaves of 5 dims whose sequence, dim 3, is
    longer than 1,024 and divides by "model")."""
    from torch.utils._pytree import tree_leaves

    specs, treedef = tree_flatten(cspec, is_leaf=is_spec)
    out = []
    for spec, leaf in zip(specs, tree_leaves(caches)):
        if (leaf.dim() >= 5 and spec[2] is None
                and leaf.shape[3] % _size(mesh, "model") == 0
                and leaf.shape[3] > 1024):
            lst = list(spec) + [None] * (leaf.dim() - len(spec))
            lst[3] = "model" if lst[3] is None else lst[3]
            spec = tuple(lst)
        out.append(spec)
    return tree_unflatten(out, treedef)


def serve_cache_specs(mesh, caches: Pytree, batch: int,
                      seq_shard_decode: bool = False) -> Pytree:
    """The specs prefill and decode lay their caches out by: `cache_specs`
    with the JAX `launch/perf.py`'s batch-1 rule (`seq_sharded = batch ==
    1`: the sequence, or a recurrent state's K dim, over the data axes),
    under `seq_shard_decode` the sequence over "model" where the heads are
    not (`seq_shard_over_model`), and MLA's latent cache (B, S, r) never
    with its sequence on "model" (`cache_specs` reads its dim 2 as heads
    where it is at most 512 long)."""
    specs = cache_specs(mesh, caches, batch, seq_sharded=batch == 1)
    if seq_shard_decode:
        specs = seq_shard_over_model(specs, caches, mesh)
    tp = tp_axis(mesh)
    leaves, treedef = tree_flatten_with_path(caches)
    flat = []
    for (path, _), spec in zip(leaves, tree_flatten(specs, is_leaf=is_spec)[0]):
        if _path_str(path).rsplit("/", 1)[-1] in _SEQ_DIM2_LEAVES:
            spec = tuple(None if i == 2 and e == tp else e
                         for i, e in enumerate(spec))
        flat.append(spec)
    return tree_unflatten(flat, treedef)


def lay_out_cache(caches: Pytree, mesh, specs: Pytree) -> Pytree:
    """Every cache leaf as a DTensor on `mesh` laid out by its spec
    (`serve_cache_specs`): of a plain leaf, the whole zeroed (or filled)
    tensor on every rank, each rank keeps its shard; a DTensor leaf is
    redistributed. The leaves keep their tree (`KVCache`s, states)."""
    dm = device_mesh(mesh)
    leaves, treedef = tree_flatten(caches)
    spec_leaves = tree_flatten(specs, is_leaf=is_spec)[0]
    return tree_unflatten([placed(x, to_placements(s, dm), dm)
                           for x, s in zip(leaves, spec_leaves)], treedef)


def assign(dst, src) -> None:
    """`dst.copy_(src)` in place, no gradient: for a DTensor `dst` (a cache
    leaf, or a view of one layer of it) each rank copies into its own local
    shard, `src` laid out as `dst` first, so `dst` keeps its placements and
    the write lands in the stacked cache it views."""
    import torch

    with torch.no_grad():
        if not is_dtensor(dst):
            dst.copy_(src)
            return
        src = placed(src, dst.placements, dst.device_mesh)
        dst.to_local().copy_(src.to_local())


def shard_start(n: int, mesh, placements, dim: int):
    """(first index, count) of this rank's shard of a dim `n` long under
    `placements`, sharded evenly over every mesh dim that names it, in mesh
    order as DTensor nests them."""
    from torch.distributed.tensor import Shard

    first, coord = 0, mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p == Shard(dim):
            n //= mesh.size(i)
            first += coord[i] * n
    return first, n


def write_rows(dst, src, write, seq_dim: int) -> None:
    """`write(dst, src, first, row0)` into a cache leaf in place, no
    gradient: `src` in `dst`'s dtype, `first` the absolute index of `dst`'s
    first slot along `seq_dim`, `row0` that of its first batch row (dim 0).
    A plain `dst` is written whole (0, 0). For a DTensor `dst` each rank
    writes into its own local shard: `src` is laid out as `dst` on every
    mesh dim but those that split `seq_dim`, where it is whole (so the
    batch and head shards write their own rows, and under a sequence split
    each rank the positions it holds, by `first`)."""
    import torch

    with torch.no_grad():
        if not is_dtensor(dst):
            write(dst, src.to(dst.dtype), 0, 0)
            return
        from torch.distributed.tensor import Replicate, Shard

        mesh = dst.device_mesh
        sp = [Replicate() if p == Shard(seq_dim) else p
              for p in dst.placements]
        first, _ = shard_start(dst.shape[seq_dim], mesh, dst.placements,
                               seq_dim)
        row0, _ = shard_start(dst.shape[0], mesh, dst.placements, 0)
        src = placed(src, sp, mesh)
        write(dst.to_local(), src.to_local().to(dst.dtype), first, row0)


def replicating(sharded: bool):
    """DTensor's `implicit_replication` for a sharded step (plain tensors
    made inside it, such as positions, masks and the step count, are
    replicated), nothing otherwise."""
    if not sharded:
        import contextlib

        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def is_spec(x) -> bool:
    """Whether `x` is a spec (a plain tuple of None, axis names and tuples
    of axis names), not a container of them: for `tree_leaves(specs,
    is_leaf=is_spec)`."""
    return type(x) is tuple and all(
        e is None or isinstance(e, str)
        or (type(e) is tuple and all(isinstance(a, str) for a in e))
        for e in x)


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """A leaf's per-device shape under its spec: each sharded dim divided
    by the product of its axes' sizes."""
    out = []
    for d, axes in zip(shape, spec):
        if axes is None:
            out.append(int(d))
            continue
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        out.append(int(d) // math.prod(_size(mesh, a) for a in names))
    return tuple(out)


# -- placements on a DeviceMesh -----------------------------------------------
def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh` (a `DeviceMesh` with named
    dims), one per mesh dim: `Shard(d)` on every mesh dim named in spec
    entry d, `Replicate()` on the rest. An entry of several axes, such as
    ("pod", "data"), shards its dim over each of them in mesh order, as
    `NamedSharding` does; like it, a mesh axis shards one tensor dim at
    most. Axes the mesh lacks raise."""
    from torch.distributed.tensor import Replicate, Shard

    names = _names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        dims = [names.index(a) if a in names else None for a in axes]
        if None in dims:
            raise ValueError(f"spec {spec} names an axis {axes} the mesh "
                             f"{names} lacks")
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{names}: DTensor shards a dim over several "
                             "mesh dims in mesh order only")
        for i in dims:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"of spec {spec}")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's layout: its `DeviceMesh` and its placements there (the
    port's `NamedSharding`)."""

    mesh: Any
    placements: tuple


def device_mesh(mesh):
    """The `DeviceMesh` of `mesh`: a `launch/mesh.py::Mesh` laid over a
    process group, or a `DeviceMesh` itself."""
    dm = getattr(mesh, "device_mesh", mesh)
    if dm is None:
        raise ValueError(f"mesh {dict(mesh.shape)} is laid over no process "
                         "group (launch/mesh.py::lay_over, described)")
    return dm


def to_shardings(specs: Pytree, mesh) -> Pytree:
    """`Sharding(device mesh, to_placements(spec, mesh))` for every spec of
    a tree (`is_spec` leaves), in the specs' structure: JAX's
    `to_shardings`."""
    dm = device_mesh(mesh)
    return tree_map(lambda s: Sharding(dm, to_placements(s, dm)), specs,
                    is_leaf=is_spec)


def distribute(x, sharding: Sharding):
    """A whole tensor, the same on every rank, as a DTensor laid out by
    `sharding`: each rank keeps its own shard (`src_data_rank=None`: no
    collective, every rank already holds the whole tensor)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, sharding.mesh, list(sharding.placements),
                             src_data_rank=None)


def lay_out(tree: Pytree, mesh, device=None) -> Pytree:
    """Every tensor leaf of `tree` as a DTensor on `mesh`, laid out by its
    `param_specs` rule (by path and name, so Adam's mu and nu match their
    params, anything unnamed replicates); other leaves as they are. A
    plain leaf, the whole tensor on every rank, goes to `device` first and
    each rank keeps its shard; a DTensor leaf is redistributed on its own
    mesh."""
    import torch

    dm = device_mesh(mesh)

    def place(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        spec = _spec_for(path, path.rsplit("/", 1)[-1], tuple(x.shape), dm)
        if is_dtensor(x):
            return placed(x, to_placements(spec, x.device_mesh))
        return distribute(x if device is None else x.to(device),
                          Sharding(dm, to_placements(spec, dm)))

    return _map_with_path(place, tree)


def placed(x, placements, mesh=None):
    """`x` laid out by `placements`: a DTensor redistributed where its
    placements differ; a plain tensor, whole on every rank, distributed on
    `mesh`."""
    if not is_dtensor(x):
        return distribute(x, Sharding(mesh, tuple(placements)))
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, list(placements))


def split_last(y, shape):
    """`y` with its last dim reshaped to `shape` (its product). A DTensor
    sharded on that dim over a mesh dim that `shape[0]` does not divide
    (GQA's KV heads: Yi-6B's 4 over a "model" of 16; SwiGLU's fused
    [gate | up] pair) is replicated there first: DTensor cannot cut the
    leading split dim, and the JAX package's pins replicate it too."""
    if is_dtensor(y):
        from torch.distributed.tensor import Replicate, Shard

        mesh, last = y.device_mesh, Shard(y.ndim - 1)
        y = placed(y, [Replicate() if p == last and shape[0] % mesh.size(i)
                       else p for i, p in enumerate(y.placements)])
    return y.reshape(tuple(y.shape[:-1]) + tuple(shape))


def head_columns(w, heads: int):
    """A weight w (K, heads·width) for a product whose output is cut into
    `heads` heads: a DTensor's column shards gathered on each mesh dim
    that does not divide `heads` (MiniCPM3's 40 over a "model" of 16),
    where the pins would replicate the heads of the product; gathering the
    weight moves far fewer bytes than the product (MLA's expands the whole
    latent cache). A plain tensor, or shards that divide, as they are."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard

    last, mesh = Shard(w.ndim - 1), w.device_mesh
    return placed(w, [Replicate() if p == last and heads % mesh.size(i)
                      else p for i, p in enumerate(w.placements)])


def gathered(w):
    """A weight for its use: a DTensor's shards over the data axes (its
    FSDP axis) gathered, its "model" shards kept (ZeRO-3: the per-layer
    all-gather XLA inserts). The redistribute's backward reduce-scatters
    the weight's gradient back to its shards, and the gathered weight is
    what the product's backward reads, so no activation moves for it. A
    plain tensor is returned as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard

    names = _names(w.device_mesh)
    return placed(w, [Replicate() if names[i] in BATCH_AXES
                      and isinstance(p, Shard) else p
                      for i, p in enumerate(w.placements)])


def matmul(x, w):
    """`x @ w` for activations x (..., K) and a weight w (K, N); for
    DTensors the product each rank takes of its shards, as GSPMD
    partitions it under the rules (`local_map`, so that the backward is as
    local as the forward; DTensor's per-op choice replicated the MLP's
    hidden dim in the backward). Per mesh dim: rows of x over a data axis
    with w whole (w's FSDP shards gathered: `gathered`) give rows of the
    product; columns of w over "model" give its columns (column parallel);
    x's and w's contraction dim over "model" gives a partial sum (row
    parallel, reduced at the next pin); anything else is replicated. A
    replicated operand's gradient is a partial sum where the other split
    the work."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    w = gathered(w)
    mesh = w.device_mesh
    last = Shard(x.ndim - 1)
    xp, wp, op, xg, wg = [], [], [], [], []
    for i, (a, b) in enumerate(zip(x.placements, w.placements)):
        if a == Shard(0) and b == Replicate():
            xp.append(a), wp.append(b), op.append(Shard(0))
            xg.append(a), wg.append(Partial())
        elif a == last and b == Shard(0):
            xp.append(a), wp.append(b), op.append(Partial())
            xg.append(a), wg.append(b)
        elif b == Shard(1):
            xp.append(Replicate()), wp.append(b), op.append(Shard(x.ndim - 1))
            xg.append(Partial()), wg.append(b)
        else:
            keep = a if a == Shard(0) else Replicate()
            xp.append(keep), wp.append(Replicate())
            op.append(keep)
            xg.append(keep), wg.append(Partial() if keep != Replicate()
                                       else Replicate())

    return local_map(lambda a, b: a @ b, out_placements=op,
                     in_placements=(xp, wp), in_grad_placements=(xg, wg),
                     device_mesh=mesh)(placed(x, xp), placed(w, wp))


def shard_hint(x, *axes):
    """The JAX package's layout pin (`with_sharding_constraint`, a no-op
    off-mesh). On a DTensor, `axes` (one entry a dim: None, an axis name or
    a tuple of them) are cleaned against its mesh, dropping the axes it
    lacks and those whose sizes do not divide the dim, and `x` is
    redistributed to the result where its placements differ (a pending
    partial sum is reduced there). A plain tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    names, sizes = _names(mesh), _sizes(mesh)

    def clean(dim, entry):
        cand = tuple(a for a in _axes_of(entry) if a in names)
        size = math.prod(sizes[a] for a in cand)
        if not cand or dim % size:
            return None
        return cand if len(cand) > 1 else cand[0]

    spec = tuple(clean(x.shape[i], axes[i]) if i < len(axes) else None
                 for i in range(x.ndim))
    return placed(x, to_placements(spec, mesh))


__all__ = ["BATCH_AXES", "Sharding", "batch_specs", "cache_specs",
           "assign", "data_axes", "device_mesh", "distribute", "fsdp_axis",
           "gathered", "head_columns",
           "is_spec", "lay_out", "lay_out_cache", "local_shape", "matmul",
           "opt_specs", "param_specs", "placed", "replicating",
           "seq_shard_over_model", "serve_cache_specs", "set_moe_ep_only",
           "shard_hint", "shard_start", "split_last", "to_placements",
           "to_shardings", "tp_axis", "write_rows"]
