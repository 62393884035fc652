"""A carry written in place: the port's counterpart of XLA's donation.

The JAX package donates a step's carry, so XLA may write the new carry
into the old one's buffers. Here the pools' stateful steps
(`pool/envpool.py`, `pool/sharded.py`, `pool/async_pool.py`) and the fused
trainer's CUDA graphs (`train/fused.py`) copy each new carry leaf into the
buffer of the old one: the carry keeps its memory from step to step, which
the audit checks (`analysis/audit.py`, `launch/graph_analysis.py::
written_in_place`). A leaf the step already wrote in place is its own
buffer and is not copied.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_map


def storage(x: torch.Tensor) -> int:
    return x.untyped_storage().data_ptr()


def adopt(tree):
    """`tree` with every tensor leaf that shares memory with an earlier
    leaf, or is not contiguous (an expanded view overlaps itself), cloned:
    each leaf then owns its buffer and can be written in place."""
    seen = set()

    def own(x):
        if isinstance(x, torch.Tensor) and x.numel():
            if storage(x) in seen or not x.is_contiguous():
                x = x.clone(memory_format=torch.contiguous_format)
            seen.add(storage(x))
        return x

    return tree_map(own, tree)


def write_back(buffers: List[torch.Tensor], new: List[torch.Tensor]) -> None:
    """Copy each new leaf into its buffer. A leaf the step wrote in place is
    its buffer already; a new leaf that lies in another buffer's memory is
    cloned before any buffer is written."""
    static = {storage(b) for b in buffers if b.numel()}
    srcs: List[Optional[torch.Tensor]] = []
    for dst, src in zip(buffers, new, strict=True):
        if (src.shape, src.dtype) != (dst.shape, dst.dtype):
            raise ValueError(f"a carry leaf changed from {dst.dtype}"
                             f"{tuple(dst.shape)} to {src.dtype}"
                             f"{tuple(src.shape)}")
        if src is dst or (src.data_ptr() == dst.data_ptr()
                          and src.stride() == dst.stride()):
            srcs.append(None)
        elif src.numel() and storage(src) in static:
            srcs.append(src.clone())
        else:
            srcs.append(src)
    for dst, src in zip(buffers, srcs):
        if src is not None:
            dst.copy_(src)


def write_carry(old, new):
    """Write the tree `new` into the tree `old` leaf by leaf (`write_back`)
    and return `old`, whose leaves keep their memory."""
    olds, spec = tree_flatten(old)
    news, new_spec = tree_flatten(new)
    if spec != new_spec:
        raise ValueError("a step changed the structure of its carry")
    write_back(olds, news)
    return old


__all__ = ["adopt", "storage", "write_back", "write_carry"]
