"""What the audit reads off a step: host nodes of a captured CUDA graph,
a carry written in place, the allocator's peak.

The counterpart of `repro.launch.hlo_analysis`, whose functions parse the
HLO text XLA compiles a step into. PyTorch compiles no HLO: a step runs
eagerly, or as a CUDA graph captured from it (`train/fused.py`). So the
questions the JAX audit asks of the HLO are asked of what the port runs:

  - `host_transfer_ops(graph)` (HLO: infeed/outfeed/send/recv/callbacks):
    the nodes of a captured graph that involve the host, host nodes and
    copies from or to host memory, read through the CUDA runtime PyTorch
    loaded (`cudaGraphGetNodes`, `cudaGraphNodeGetType`, each copy's
    `cudaGraphMemcpyNodeGetParams` and its pointers' memory type) from a
    graph captured with `keep_graph=True` (`torch.cuda.CUDAGraph`). On an
    NVIDIA H100 80GB HBM3 with PyTorch 2.11 (CUDA 12.8) `debug_dump` of a
    graph in debug mode wrote an empty file, so the DOT print is not read;
  - `written_in_place(before, after)` (HLO: `donated_params`, the
    `tf.aliasing_output` of each carry parameter): the carry leaves whose
    `data_ptr()` moved across a step;
  - `peak_live_bytes(fn)` (HLO: a liveness scan of the entry computation):
    the CUDA caching allocator's peak over one call.

XLA's static flops and bytes have no counterpart here: the cost model
(`analysis/cost.py`) counts them from shapes.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, List

import torch
from torch.utils._pytree import keystr, tree_flatten_with_path

#: cudaGraphNodeType, by value (CUDA runtime API)
NODE_TYPES = {0: "KERNEL", 1: "MEMCPY", 2: "MEMSET", 3: "HOST", 4: "GRAPH",
              5: "EMPTY", 6: "WAIT_EVENT", 7: "EVENT_RECORD",
              8: "EXT_SEMAS_SIGNAL", 9: "EXT_SEMAS_WAIT", 10: "MEM_ALLOC",
              11: "MEM_FREE", 12: "BATCH_MEM_OP", 13: "CONDITIONAL"}
#: cudaMemcpyKind values whose copy has host memory at an end
#: (HostToHost, HostToDevice, DeviceToHost); Default (4) is decided by the
#: pointers
_HOST_KINDS = (0, 1, 2)
_DEFAULT_KIND = 4
#: cudaMemoryType values of host memory: unregistered, host (page-locked)
_HOST_MEMORY = (0, 1)


class _Pos(ctypes.Structure):
    _fields_ = [("x", ctypes.c_size_t), ("y", ctypes.c_size_t),
                ("z", ctypes.c_size_t)]


class _PitchedPtr(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("pitch", ctypes.c_size_t),
                ("xsize", ctypes.c_size_t), ("ysize", ctypes.c_size_t)]


class _Memcpy3DParms(ctypes.Structure):
    """cudaMemcpy3DParms."""
    _fields_ = [("srcArray", ctypes.c_void_p), ("srcPos", _Pos),
                ("srcPtr", _PitchedPtr), ("dstArray", ctypes.c_void_p),
                ("dstPos", _Pos), ("dstPtr", _PitchedPtr), ("extent", _Pos),
                ("kind", ctypes.c_int)]


class _PointerAttributes(ctypes.Structure):
    """cudaPointerAttributes."""
    _fields_ = [("type", ctypes.c_int), ("device", ctypes.c_int),
                ("devicePointer", ctypes.c_void_p),
                ("hostPointer", ctypes.c_void_p)]


def _cudart():
    """The CUDA runtime library this process loaded (PyTorch's), typed."""
    with open("/proc/self/maps") as f:
        paths = [line.split()[-1] for line in f if "libcudart.so" in line]
    if not paths:
        raise RuntimeError("no CUDA runtime is loaded in this process")
    lib = ctypes.CDLL(paths[0])
    ptr, size = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
    lib.cudaGraphGetNodes.argtypes = [ptr, ptr, size]
    lib.cudaGraphNodeGetType.argtypes = [ptr, ctypes.POINTER(ctypes.c_int)]
    lib.cudaGraphMemcpyNodeGetParams.argtypes = [
        ptr, ctypes.POINTER(_Memcpy3DParms)]
    lib.cudaPointerGetAttributes.argtypes = [
        ctypes.POINTER(_PointerAttributes), ptr]
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: cudaError {rc}")


def _host_pointer(lib, p) -> bool:
    attrs = _PointerAttributes()
    _check(lib.cudaPointerGetAttributes(ctypes.byref(attrs),
                                        ctypes.c_void_p(p)),
           "cudaPointerGetAttributes")
    return attrs.type in _HOST_MEMORY


def graph_nodes(graph) -> List[Dict]:
    """[{"id", "type", "host"}] of every node of a captured
    `torch.cuda.CUDAGraph(keep_graph=True)`: its type, and whether it
    involves the host (a host node, or a copy from or to host memory)."""
    lib = _cudart()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(lib.cudaGraphGetNodes(raw, None, ctypes.byref(n)),
           "cudaGraphGetNodes")
    handles = (ctypes.c_void_p * n.value)()
    _check(lib.cudaGraphGetNodes(raw, handles, ctypes.byref(n)),
           "cudaGraphGetNodes")
    out = []
    for i, node in enumerate(handles[:n.value]):
        t = ctypes.c_int(-1)
        _check(lib.cudaGraphNodeGetType(ctypes.c_void_p(node),
                                        ctypes.byref(t)),
               "cudaGraphNodeGetType")
        kind = NODE_TYPES.get(t.value, f"TYPE_{t.value}")
        host = kind == "HOST"
        if kind == "MEMCPY":
            p = _Memcpy3DParms()
            _check(lib.cudaGraphMemcpyNodeGetParams(ctypes.c_void_p(node),
                                                    ctypes.byref(p)),
                   "cudaGraphMemcpyNodeGetParams")
            host = p.kind in _HOST_KINDS or (
                p.kind == _DEFAULT_KIND
                and any(_host_pointer(lib, x) for x in (p.srcPtr.ptr,
                                                        p.dstPtr.ptr) if x))
        out.append({"id": i, "type": kind, "host": host})
    return out


def host_transfer_nodes(nodes: List[Dict]) -> List[str]:
    """The nodes among `graph_nodes`' that involve the host, as
    "<type>#<id>"."""
    return [f"{n['type']}#{n['id']}" for n in nodes if n["host"]]


def host_transfer_ops(graph) -> List[str]:
    """Host nodes and host-memory copies of a captured graph: empty on a
    device-resident step."""
    return host_transfer_nodes(graph_nodes(graph))


def leaf_ptrs(tree) -> Dict[str, int]:
    """{leaf path: data_ptr()} of a carry's tensor leaves."""
    leaves, _ = tree_flatten_with_path(tree)
    return {keystr(path): x.data_ptr() for path, x in leaves
            if isinstance(x, torch.Tensor)}


def _ptrs(x) -> Dict[str, int]:
    if isinstance(x, dict) and all(isinstance(v, int) for v in x.values()):
        return x
    return leaf_ptrs(x)


def written_in_place(before, after) -> List[str]:
    """The leaf paths of a carry whose memory moved between `before` and
    `after` (each a carry, or its `leaf_ptrs`): empty where every leaf was
    written in place, the port's donation. A leaf missing on either side
    counts as moved."""
    before, after = _ptrs(before), _ptrs(after)
    return sorted(k for k in set(before) | set(after)
                  if before.get(k) != after.get(k))


def peak_live_bytes(fn: Callable[[], object], device) -> int:
    """The CUDA caching allocator's peak of allocated bytes on `device`
    while `fn()` runs (what was live before it included)."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


__all__ = ["NODE_TYPES", "graph_nodes", "host_transfer_nodes",
           "host_transfer_ops", "leaf_ptrs", "peak_live_bytes",
           "written_in_place"]
