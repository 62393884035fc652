"""Mesh-agnostic checkpointing: atomic, keep-k, restorable onto any mesh
(port of `repro.checkpoint.manager`, in the same on-disk format).

Format: one directory per step containing
  - `tree.json`   : the step, a structure string and every leaf's path,
                    shape and dtype (the tree's schema)
  - `arrays.npz`  : one entry per leaf, keyed by its path string: the
                    string `jax.tree_util.keystr` gives for the same tree
                    (`['env_state'].inner.key`: dict keys in brackets and
                    sorted, NamedTuple fields after a dot, sequence items by
                    index), so either package restores the other's files
  - `meta.json`   : optional host-side metadata (the env service's session
                    bookkeeping: anything JSON, written atomically with the
                    arrays)

Arrays are stored gathered (whole-batch numpy), so a checkpoint written
from a pool over two devices restores onto one, or onto the CPU. A tree
of DTensors (a state sharded over a mesh) is gathered the same way: every
rank joins each leaf's `full_tensor()`, rank 0 writes, and every rank
waits for the write at a barrier (in `save`, or in `wait` after a
non-blocking save). `restore(template, step, shardings=)` lays each leaf
out on any mesh (`sharding.rules.to_shardings`), so a checkpoint written
by the JAX package, by the port on one device or by a sharded run
restores into each of the others.

Writes are atomic (a tmp dir, then `os.replace`), so a preemption mid-save
never corrupts the latest checkpoint; `save(..., blocking=False)` runs the
write off the caller's thread. The device-to-host gather always runs on
the caller's thread and is complete when `save` returns: the port's pools
write their carries in place, so a snapshot still aliasing device memory,
or a copy still in flight, would be torn by the next step.

Concurrency contract (as the JAX package's):
  - writes are SERIALIZED: a save (blocking or not) never starts until the
    previous write, and its keep-k GC, has finished;
  - the writer thread is non-daemon, so an interpreter exit joins it;
  - `wait()` joins the in-flight write and re-raises its error, `close()`
    is wait + refuse further saves (also usable as a context manager).

Fault injection: `_pre_replace_hook`, when set, runs after the tmp dir is
fully written and immediately before the atomic rename, the window a
preemption mid-save lands in (runtime/failures.py's "preempt_save").
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

Pytree = Any


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(path piece, child) pairs of a container in JAX's flatten order, or
    None for a leaf. None is an empty container, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(tree)]
    return None


def flatten_with_path(tree: Pytree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path string, leaf)], the path strings those of `keystr`."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [item for piece, child in kids
            for item in flatten_with_path(child, prefix + piece)]


def map_with_path(fn: Callable[[str, Any], Any], tree: Pytree,
                  prefix: str = "") -> Pytree:
    """`tree` with every leaf replaced by `fn(path, leaf)`."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + f"[{k!r}]")
                for k, v in tree.items()}
    out = [map_with_path(fn, child, prefix + piece) for piece, child in kids]
    if hasattr(tree, "_fields"):
        return type(tree)(*out)
    return type(tree)(out)


def structure(tree: Pytree) -> str:
    """A structure string in the style of JAX's `str(treedef)`."""
    def walk(t):
        kids = _children(t)
        if kids is None:
            return "*"
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        inner = ", ".join(walk(c) for _, c in kids)
        if hasattr(t, "_fields"):
            return f"CustomNode(namedtuple[{type(t).__name__}], [{inner}])"
        return f"[{inner}]" if isinstance(t, list) else f"({inner})"
    return f"PyTreeDef({walk(tree)})"


def _host_copy(leaf) -> np.ndarray:
    """A host copy of one leaf, complete when this returns (a DTensor's
    whole value: a collective every rank of its mesh joins)."""
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf, copy=True)


def _is_dtensor(x) -> bool:
    from repro_torch.kernels import is_dtensor

    return is_dtensor(x)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def _flatten(tree: Pytree) -> Dict[str, np.ndarray]:
    return {path: _host_copy(leaf) for path, leaf in flatten_with_path(tree)}


def _as_template(arr: np.ndarray, leaf, sharding=None):
    """`arr` in `leaf`'s dtype, as a tensor on the leaf's device where the
    leaf is a tensor; a DTensor laid out by `sharding` where one is given
    (`sharding.rules.Sharding`), or as the leaf is where the leaf is a
    DTensor."""
    from repro_torch.sharding import rules

    if sharding is None and _is_dtensor(leaf):
        sharding = rules.Sharding(leaf.device_mesh, tuple(leaf.placements))
    if isinstance(leaf, torch.Tensor):
        dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
        device = leaf.device
        if sharding is not None:
            from repro_torch.runtime.elastic import _mesh_device

            device = _mesh_device(sharding.mesh)
        t = torch.as_tensor(arr.astype(dtype), device=device)
        return t if sharding is None else rules.distribute(t, sharding)
    if sharding is not None:
        raise TypeError("a sharding for a non-tensor template leaf")
    return arr.astype(np.asarray(leaf).dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._write_lock = threading.Lock()  # serializes write + keep-k GC
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._closed = False
        #: a sharded save whose write every rank still waits for
        self._sharded_pending = False
        #: test seam: called with the tmp path between the fully written tmp
        #: dir and the atomic os.replace (the mid-save preemption window)
        self._pre_replace_hook: Optional[Callable[[str], None]] = None

    # -- write ---------------------------------------------------------------
    def save(self, step: int, tree: Pytree, blocking: bool = True,
             meta: Optional[Dict] = None) -> str:
        if self._closed:
            raise RuntimeError(f"CheckpointManager({self.directory}) is closed")
        self.wait()  # serialize: one write in flight, errors surface here
        sharded = any(_is_dtensor(x) for _, x in flatten_with_path(tree))
        flat = _flatten(tree)  # gather on the caller thread (device -> host)
        schema = {
            "step": step,
            "treedef": structure(tree),
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in flat.items()},
        }

        def write():
            with self._write_lock:
                final = os.path.join(self.directory, f"step_{step:010d}")
                tmp = final + ".tmp"
                shutil.rmtree(tmp, ignore_errors=True)  # stale preempted write
                os.makedirs(tmp)
                np.savez(os.path.join(tmp, "arrays.npz"), **flat)
                with open(os.path.join(tmp, "tree.json"), "w") as f:
                    json.dump(schema, f)
                if meta is not None:
                    with open(os.path.join(tmp, "meta.json"), "w") as f:
                        json.dump(meta, f)
                if self._pre_replace_hook is not None:
                    self._pre_replace_hook(tmp)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
                self._gc()

        if sharded:
            # every rank gathered; rank 0 writes, the others meet it at
            # the barrier
            self._sharded_pending = True  # repro: allow[unguarded-mutation] owner thread only, as _closed: save()/wait() run on one owner thread
            if _rank() != 0:
                if blocking:
                    self.wait()
                return os.path.join(self.directory, f"step_{step:010d}")
        if blocking:
            write()
            self.wait()
        else:
            # non-daemon: interpreter exit joins the write instead of
            # dropping it mid-file
            # repro: allow[unguarded-mutation] single-writer contract: save()/wait()/close() run on one owner thread; _write_lock only serializes the directory writes
            self._thread = threading.Thread(
                target=self._run_write, args=(write,),
                name=f"ckpt-save-{step}", daemon=False)
            self._thread.start()
        return os.path.join(self.directory, f"step_{step:010d}")

    def _run_write(self, write) -> None:
        try:
            write()
        except BaseException as e:  # repro: allow[silent-except,unguarded-mutation] not swallowed: stored and re-raised by wait(); the store is ordered before the owner's join()
            self._error = e

    def wait(self) -> None:
        """Join the in-flight write; re-raise its error, if any. After a
        sharded save every rank meets at a barrier here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None  # repro: allow[unguarded-mutation] owner-thread bookkeeping; join() above is the happens-before for _error
        if self._sharded_pending:
            self._sharded_pending = False  # repro: allow[unguarded-mutation] owner thread only, after join()
            _barrier()
        if self._error is not None:
            # repro: allow[unguarded-mutation] owner thread only, after join()
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        """Join pending writes and refuse further saves."""
        self._closed = True  # repro: allow[unguarded-mutation] owner-thread latch; save() checks it on the same thread
        self.wait()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- read ----------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_path(self, step: Optional[int]) -> str:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return os.path.join(self.directory, f"step_{step:010d}")

    def read_meta(self, step: Optional[int] = None) -> Optional[Dict]:
        """The `meta=` dict written with the checkpoint (None if absent)."""
        path = os.path.join(self._step_path(step), "meta.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def restore(self, template: Pytree, step: Optional[int] = None,
                shardings: Optional[Pytree] = None) -> Pytree:
        """Restore into `template`'s structure and dtypes: numpy leaves for
        numpy template leaves, tensors on the template leaf's device for
        tensor leaves (so a checkpoint written from the card restores onto
        the CPU, and back). `shardings` (a tree of
        `sharding.rules.Sharding`s in the template's structure, such as
        `rules.to_shardings(rules.param_specs(template, mesh), mesh)`) may
        target ANY mesh: each leaf becomes a DTensor laid out by its own,
        every rank of the mesh keeping its shard. A DTensor template leaf
        with no sharding given is laid out as it is."""
        path = self._step_path(step)
        by_path = (dict(flatten_with_path(shardings))
                   if shardings is not None else {})
        with np.load(os.path.join(path, "arrays.npz")) as data:
            def load(key, leaf):
                if key not in data:
                    raise KeyError(f"checkpoint missing leaf {key}")
                arr = data[key]
                want = tuple(leaf.shape if isinstance(leaf, torch.Tensor)
                             else np.shape(leaf))
                if tuple(arr.shape) != want:
                    raise ValueError(f"shape mismatch at {key}: ckpt "
                                     f"{arr.shape} vs template {want}")
                return _as_template(arr, leaf, by_path.get(key))

            return map_with_path(load, template)


__all__ = ["CheckpointManager", "flatten_with_path", "map_with_path",
           "structure"]
