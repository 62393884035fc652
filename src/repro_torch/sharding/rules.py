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
or JAX's `AbstractMesh`). The JAX package's `shard_hint` pins activation
layouts inside jitted code; one card has nothing to pin, so it is not
ported.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

from torch.utils._pytree import (MappingKey, SequenceKey, GetAttrKey,
                                 tree_flatten_with_path, tree_map,
                                 tree_unflatten)

Pytree = Any
Spec = Tuple[Any, ...]

BATCH_AXES = ("pod", "data")


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in BATCH_AXES if a in mesh.axis_names)


def _entry(axes: Tuple[str, ...]):
    """A spec entry of several axes: one axis stands as its name (as a
    PartitionSpec holds it)."""
    return axes[0] if len(axes) == 1 else axes


def fsdp_axis(mesh):
    return "data" if "data" in mesh.axis_names else None


def tp_axis(mesh):
    return "model" if "model" in mesh.axis_names else None


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


def _size(mesh, axis: str) -> int:
    return int(mesh.shape[axis])


def _spec_for(path: str, name: str, shape, mesh) -> Spec:
    ndim = len(shape)
    axes_avail = set(mesh.axis_names)
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


__all__ = ["BATCH_AXES", "batch_specs", "cache_specs", "data_axes",
           "fsdp_axis", "is_spec", "local_shape", "opt_specs", "param_specs",
           "set_moe_ep_only", "tp_axis"]
