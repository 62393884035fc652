"""AsyncEnvPool: the EnvPool's async mode over the megastep (port of
`repro.pool.async_pool`).

Clients `send(actions, ids)` for the lanes that are ready and `recv()`
advances exactly those lanes. The batch is a fixed table of *slots*
(lanes) on the pool's device; an `active` mask gates which slot rows move
(the megastep or the vmap step steps every lane, then
`ops.keep_idle_state` gives the idle lanes their state, key and obs back),
and a departed session's slot is refilled by writing a freshly reset
session's rows into it, in place.

Sessions and determinism, as in the JAX package: `admit(seed=s)` seeds a
lane exactly as `EnvPool(env, 1).reset(seed=s)` seeds its only lane, and
the masked vmap step splits its step key over the slots as `Vec.step`
does. So a session's trajectory equals the same seed run alone through the
lock-step pool, however the other slots are scheduled or recycled, and
with every lane active the lock-step facade (`reset(seed)` /
`step(actions)`) is `EnvPool(..., backend="vmap")`'s.

`recv` gathers the ready rows on the device and makes one copy to the
host, into page-locked memory (the JAX pool copies the whole table, to
keep XLA from compiling per ready-set size, a cost PyTorch does not pay).
The recv key chain, whose split only the vmap step reads, advances on the
host, so a fused recv launches no threefry.

Threading: `send` / `recv` are safe from many client threads; the pool's
device work runs under its condition's lock, on the stream that was
current when the pool was built. `recv(max_wait=, min_ready=)` blocks
until `min_ready` lanes have actions staged (or the wait times out).
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch import random as R
from repro_torch.core.carry import adopt, write_carry
from repro_torch.core.env import Env, supports_fused_step
from repro_torch.core.registry import make as registry_make
from repro_torch.core.spaces import sample_batch
from repro_torch.core.wrappers import AutoReset, Vec
from repro_torch.device import resolve_device
from repro_torch.kernels.envstep.ops import keep_idle_state
from repro_torch.pool.envpool import (FUSED_BACKENDS, _load_like, _to_numpy,
                                      auto_backend, check_backend)


class AsyncUnsupportedError(TypeError):
    """Raised when an env cannot be hosted by the async pool.

    Named, so the registry-completeness sweep can assert that every id
    either builds or fails loudly with this error."""


@functools.lru_cache(maxsize=None)
def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def seed_keys(seeds) -> np.ndarray:
    """`split(PRNGKey(s), 1)[0]` for each seed, on the host in numpy: the
    auto-reset key `admit(seed=s)` resets a lane from, as a 1-lane
    `EnvPool.reset(s)` derives its only lane's. (n, 2) int64."""
    seeds = np.asarray(seeds, np.int64) & 0xFFFFFFFF
    y0, y1 = R.threefry2x32(0, seeds, np.zeros_like(seeds),
                            np.ones_like(seeds))
    return np.stack([y0, y1], -1)


def host_split(key: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """`random.split(key)` of one (2,) key, on the host in numpy: the same
    threefry rounds, for a key chain that no device op reads."""
    counts = np.arange(4, dtype=np.int64)
    y0, y1 = R.threefry2x32(int(key[0]), int(key[1]), counts[:2], counts[2:])
    bits = np.concatenate([y0, y1])
    return bits[:2], bits[2:]


def _snapshot_leaf(x):
    return _to_numpy(x) if isinstance(x, torch.Tensor) else np.array(x,
                                                                     copy=True)


def pack(tensors) -> Tuple[torch.Tensor, list]:
    """The tensors' bytes in one uint8 buffer on their device, widest
    element types first (so every part is aligned on the host), and the
    layout `unpack` reads them back by."""
    order = sorted(range(len(tensors)),
                   key=lambda i: -tensors[i].element_size())
    parts, layout = [], [None] * len(tensors)
    for i in order:
        t = tensors[i].contiguous()
        layout[i] = (tuple(t.shape), numpy_dtype(t.dtype))
        parts.append(t.reshape(-1).view(torch.uint8))
    return torch.cat(parts), [(i, layout[i]) for i in order]


def unpack(buf: np.ndarray, layout) -> list:
    out, off = [None] * len(layout), 0
    for i, (shape, dtype) in layout:
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        out[i] = buf[off:off + n].view(dtype).reshape(shape)
        off += n
    return out


class AsyncEnvPool:
    """Session-per-slot async pool: `send(actions, ids)` / `recv() -> ids`.

    >>> pool = AsyncEnvPool("CartPole-v1", num_slots=64)
    >>> sid, obs = pool.admit(seed=7)            # a fresh session's rows
    >>> pool.send(actions, ids=[sid])
    >>> obs, rew, done, info, ids = pool.recv()  # only ready lanes stepped
    >>> pool.release(sid)                        # free the slot for refill

    Ids are slot indices (0..num_slots-1); the mapping of named clients to
    slots lives one level up, in serving/env_service.EnvService. `recv`
    returns numpy arrays, as the JAX pool's does.

    backend: "auto" is `pool.auto_backend(env, device)`: the CUDA megastep
    ("cuda") where its compiled body fits the instance, its plain version
    ("torch") off the card, the masked vmap step ("vmap") otherwise;
    "cuda", "torch" and "vmap" pin one. The table lives on `device`, the
    CUDA card unless the caller names another.
    """

    def __init__(self, env: Union[Env, str], num_slots: int,
                 backend: str = "auto", device=None, **env_kwargs):
        if isinstance(env, str):
            env = registry_make(env, **env_kwargs)
        elif env_kwargs:
            raise ValueError(f"env_kwargs {sorted(env_kwargs)} only apply "
                             "when building from a registry id")
        if not (hasattr(env, "reset") and hasattr(env, "observation_space")):
            raise AsyncUnsupportedError(
                f"async pool needs a functional Env (reset/step/spaces); "
                f"got {type(env).__name__}")
        self.env = env
        self.num_slots = int(num_slots)
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.device = resolve_device(device)
        if backend == "auto":
            backend = auto_backend(env, self.device)
        if backend in FUSED_BACKENDS and not supports_fused_step(env):
            raise AsyncUnsupportedError(
                f"backend={backend!r} needs fused megastep support, but "
                f"{env.name} has none; use backend='vmap'")
        if backend != "vmap" and backend not in FUSED_BACKENDS:
            raise ValueError(f"unknown async step backend {backend!r}")
        check_backend(env, backend, self.device)
        self.backend = backend
        self.aenv = AutoReset(env)
        self.venv = Vec(self.aenv, self.num_slots)
        self._act_dtype = numpy_dtype(env.action_space.dtype)
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)

        self._cond = threading.Condition()
        self._state = None                       # AutoResetState, (S, ...)
        self._obs: Optional[torch.Tensor] = None
        self._active = np.zeros(self.num_slots, bool)
        self._pending: Dict[int, np.ndarray] = {}  # slot -> staged action
        self._key: Optional[np.ndarray] = None     # facade step-key chain
        self._recv_key = np.array([0, 0x5C0], np.int64)  # PRNGKey(0x5C0)

    # -- spaces / metadata ---------------------------------------------------
    @property
    def observation_space(self):
        return self.env.observation_space

    @property
    def action_space(self):
        return self.env.action_space

    @property
    def num_envs(self) -> int:  # pool-protocol alias
        return self.num_slots

    def __len__(self) -> int:
        return self.num_slots

    def __repr__(self) -> str:  # pragma: no cover
        return (f"AsyncEnvPool({self.env.name}, num_slots={self.num_slots}, "
                f"active={int(self._active.sum())}, backend={self.backend!r},"
                f" device={self.device})")

    @property
    def active(self) -> np.ndarray:
        """(num_slots,) bool: which lanes host a running session."""
        return self._active.copy()

    def free_slots(self) -> List[int]:
        return [i for i in range(self.num_slots) if not self._active[i]]

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    # -- the carry -----------------------------------------------------------
    def _ensure_carry(self):
        if self._state is None:
            with self._on_stream():
                # repro: allow[unguarded-mutation] every caller holds self._cond (admit, admit_many, admit_lane, state_dict, load_state_dict)
                self._state, self._obs = adopt(self.venv.reset(
                    R.PRNGKey(0, self.device)))

    def _lane(self, slot: int):
        return {"state": tree_map(lambda x: x[slot], self._state),
                "obs": self._obs[slot]}

    def _write_lane(self, slot: int, lane) -> None:
        """Write one lane's rows into the table, in place."""
        for full, one in zip(tree_leaves(self._state),
                             tree_leaves(lane["state"]), strict=True):
            full[slot].copy_(one)
        self._obs[slot].copy_(lane["obs"])

    def _reset_lanes(self, keys: torch.Tensor, slots: List[int]):
        """Reset fresh sessions from their auto-reset keys (n, 2), in one
        batched reset, into `slots`' rows, in place; returns their obs."""
        state, obs = self.aenv.reset(keys.to(self.device))
        idx = torch.as_tensor(slots, dtype=torch.int64, device=self.device)
        for full, new in zip(tree_leaves(self._state), tree_leaves(state),
                             strict=True):
            full.index_copy_(0, idx, new)
        self._obs.index_copy_(0, idx, obs)
        return obs

    def _claim(self, slots: Optional[List[int]], n: int) -> List[int]:
        """`n` free slots: the lowest ones, or `slots` checked free."""
        if slots is None:
            free = self.free_slots()
            if len(free) < n:
                raise RuntimeError("no free slot; release() a session "
                                   "first (or queue in EnvService)")
            return free[:n]
        slots = [int(s) for s in slots]
        for s in slots:
            if self._active[s]:
                raise ValueError(f"slot {s} already hosts a session")
        if len(set(slots)) != len(slots) or len(slots) != n:
            raise ValueError(f"{n} sessions need {n} distinct slots; got "
                             f"{slots}")
        return slots

    # -- slot lifecycle ------------------------------------------------------
    def admit(self, seed: Optional[int] = None, key=None,
              slot: Optional[int] = None) -> Tuple[int, torch.Tensor]:
        """Start a session in a free slot; returns `(slot_id, first_obs)`.

        `seed=s` derives the lane key as `EnvPool(env, 1).reset(s)` derives
        its only lane's; `key=` passes an explicit auto-reset reset key.
        """
        if (seed is None) == (key is None):
            raise ValueError("admit() takes exactly one of seed= or key=")
        if key is None:
            keys = torch.from_numpy(seed_keys([seed]))
        elif isinstance(key, torch.Tensor):
            keys = key[None]
        else:
            keys = torch.as_tensor(np.asarray(key).astype(np.int64))[None]
        with self._cond:
            self._ensure_carry()
            (slot,) = self._claim(None if slot is None else [slot], 1)
            with self._on_stream():
                obs = self._reset_lanes(keys, [slot])
            self._active[slot] = True
            return slot, obs[0]

    def admit_many(self, seeds, slots: Optional[List[int]] = None
                   ) -> Tuple[List[int], torch.Tensor]:
        """Start one session per seed, each as `admit(seed=s)` would start
        it, in one batched reset: `(slot_ids, first_obs (n, ...))`. The env
        service admits each tick's fresh sessions so."""
        seeds = list(seeds)
        with self._cond:
            self._ensure_carry()
            slots = self._claim(slots, len(seeds))
            with self._on_stream():
                obs = self._reset_lanes(torch.from_numpy(seed_keys(seeds)),
                                        slots)
            self._active[slots] = True
            return slots, obs

    def release(self, sid: int) -> None:
        """End a session: free its slot for refill (its rows stay until the
        next admit writes over them; the mask keeps them inert)."""
        with self._cond:
            if not self._active[sid]:
                raise ValueError(f"slot {sid} has no running session")
            self._active[sid] = False
            self._pending.pop(sid, None)

    def lane_state(self, sid: int) -> Dict[str, Any]:
        """A host copy of one running lane's rows (state + obs), numpy
        leaves (uint32 keys): the eviction half of the env service's
        graceful degradation; `admit_lane()` resumes it exactly."""
        with self._cond:
            if not self._active[sid]:
                raise ValueError(f"slot {sid} has no running session")
            with self._on_stream():
                return tree_map(_to_numpy, self._lane(sid))

    def admit_lane(self, lane: Dict[str, Any],
                   slot: Optional[int] = None) -> Tuple[int, torch.Tensor]:
        """Resume a `lane_state()` snapshot (this pool's or the JAX pool's)
        in a free slot: `(slot, obs)`."""
        with self._cond:
            self._ensure_carry()
            (slot,) = self._claim(None if slot is None else [slot], 1)
            with self._on_stream():
                lane = _load_like(self._lane(slot), lane, self.device)
                self._write_lane(slot, lane)
            self._active[slot] = True
            return slot, lane["obs"]

    # -- snapshot / restore --------------------------------------------------
    @property
    def has_carry(self) -> bool:
        """Always: the table is built on first use, by `state_dict()` too."""
        return True

    def state_dict(self) -> Dict[str, Any]:
        """Host snapshot of the whole table, in the JAX pool's structure
        (numpy leaves, uint32 keys): the lanes' state (auto-reset keys
        included), obs, the active mask and both host key chains. Lanes
        with actions in flight must `recv()` first."""
        with self._cond:
            self._ensure_carry()
            if self._pending:
                raise RuntimeError(
                    "snapshot with actions in flight; recv() first so the "
                    "snapshot lands on a step boundary")
            has_key = self._key is not None
            tree = {
                "state": self._state,
                "obs": self._obs,
                "active": self._active,
                "recv_key": self._recv_key.astype(np.uint32),
                "facade_key": (self._key if has_key
                               else np.zeros(2, np.int64)).astype(np.uint32),
                "has_facade_key": np.asarray(has_key),
            }
            with self._on_stream():
                return tree_map(_snapshot_leaf, tree)

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        """Restore a `state_dict()` snapshot, this pool's or the JAX pool's,
        possibly into a fresh pool (the service-restart path)."""
        with self._cond:
            active = np.asarray(d["active"], bool)
            if active.shape != (self.num_slots,):
                raise ValueError(
                    f"snapshot has {active.shape[0]} slots; this pool has "
                    f"{self.num_slots}")
            self._pending.clear()
            self._ensure_carry()
            with self._on_stream():
                self._state, self._obs = adopt((
                    _load_like(self._state, d["state"], self.device),
                    _load_like(self._obs, d["obs"], self.device)))
            self._active = active.copy()
            self._recv_key = _host_key(d["recv_key"])
            self._key = (_host_key(d["facade_key"])
                         if bool(np.asarray(d["has_facade_key"])) else None)

    # -- the masked step -----------------------------------------------------
    def _stage_ready(self, key) -> Tuple[np.ndarray, Dict]:
        """Take the staged actions: (ids, the ready lanes' actions and ids
        on the device, two small host copies, and the step key where the
        vmap step reads one). Without `key` the recv key chain advances,
        on the host. Call under the lock."""
        ids = np.array(sorted(self._pending), np.int64)
        acts = np.stack([np.asarray(self._pending.pop(int(s)),
                                    self._act_dtype) for s in ids])
        if key is None:
            # repro: allow[unguarded-mutation] the caller holds self._cond (recv)
            self._recv_key, key = host_split(self._recv_key)
        staged = {"acts": torch.from_numpy(acts).to(self.device),
                  "ids": torch.from_numpy(ids).to(self.device)}
        if self.backend == "vmap":  # the fused steps read no step key
            staged["key"] = (key.to(self.device)
                             if isinstance(key, torch.Tensor)
                             else torch.as_tensor(np.asarray(key),
                                                  device=self.device))
        return ids, staged

    def _masked_step(self, actions, active, key):
        """One masked step of the table: every lane is stepped, then the
        idle lanes get their state, key and obs back (`keep_idle_state`).
        Writes the carry in place (core/carry.py). The outputs are the unmasked step's, every
        lane's: only the active lanes' rows may be read."""
        if self.backend != "vmap":
            state, ts = self.env.fused_step(
                self._state, actions[None], num_steps=1, backend=self.backend)
            obs, rew, done = ts.obs[0], ts.reward[0], ts.done[0]
            info = {k: v[0] for k, v in ts.info.items()}
        else:
            ts = self.venv.step(self._state, actions, key)  # exactly Vec.step
            state, obs, rew, done, info = (ts.state, ts.obs, ts.reward,
                                           ts.done, ts.info)
        write_carry((self._state, self._obs), keep_idle_state(
            (self._state, self._obs), (state, obs), active))
        return obs, rew, done, info

    def _step_ready(self, staged):
        """The masked step from the staged actions, and the ready rows of
        its outputs gathered and packed into one buffer, on the device
        (no host sync)."""
        ids = staged["ids"]
        acts = staged["acts"].new_zeros((self.num_slots,)
                                        + tuple(staged["acts"].shape[1:]))
        acts.index_copy_(0, ids, staged["acts"])
        active = torch.zeros(self.num_slots, dtype=torch.bool,
                             device=self.device).index_fill_(0, ids, True)
        obs, rew, done, info = self._masked_step(acts, active,
                                                 staged.get("key"))
        names = sorted(info)
        rows = [x.index_select(0, ids)
                for x in (obs, rew, done) + tuple(info[k] for k in names)]
        buf, layout = pack(rows)
        return buf, layout, names

    def _fetch(self, packed):
        """The one copy of a recv's outputs to the host: into page-locked
        memory from the card (a copy to pageable memory runs at a tenth
        of the rate), which the returned arrays keep alive."""
        buf, layout, names = packed
        host = buf
        if buf.is_cuda:
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            host.copy_(buf, non_blocking=True)
            torch.cuda.current_stream(buf.device).synchronize()
        obs, rew, done, *info = unpack(host.numpy(), layout)
        return obs, rew, done, dict(zip(names, info))

    # -- async API -----------------------------------------------------------
    def send(self, actions, ids) -> None:
        """Stage actions for lanes `ids` (one in-flight action per lane)."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if isinstance(actions, torch.Tensor):
            actions = actions.cpu().numpy()
        actions = np.asarray(actions)
        if actions.shape[0] != ids.shape[0]:
            raise ValueError(f"actions batch {actions.shape[0]} != "
                             f"{ids.shape[0]} ids")
        with self._cond:
            for i, sid in enumerate(ids):
                sid = int(sid)
                if not self._active[sid]:
                    raise ValueError(f"send to slot {sid}: no running session")
                if sid in self._pending:
                    raise ValueError(f"send to slot {sid}: action already "
                                     "in flight; recv() first")
                self._pending[sid] = actions[i]
            self._cond.notify_all()

    def recv(self, max_wait: Optional[float] = None, min_ready: int = 1,
             key=None):
        """Step every lane with a staged action: `(obs, rewards, dones,
        infos, ids)` as numpy arrays, each with leading dim len(ids)
        (slot-ascending). The arrays are views of one page-locked buffer
        per recv, which any of them keeps alive: copy a row that is kept
        past the next few recvs.

        `max_wait` (seconds) blocks until `min_ready` lanes are staged, by
        other client threads too; on timeout whatever is ready is stepped.
        `max_wait=None` steps at once and raises RuntimeError if nothing is
        in flight. `key` pins the step's RNG stream (split over the slots
        like `Vec.step`; dynamics that read no key are unaffected).
        """
        with self._cond:
            if max_wait is not None:
                self._cond.wait_for(
                    lambda: len(self._pending) >= min_ready, timeout=max_wait)
            if not self._pending:
                raise RuntimeError("recv() with no actions in flight")
            with self._on_stream():
                ids, staged = self._stage_ready(key)
                return (*self._fetch(self._step_ready(staged)), ids)

    # -- lock-step facade ----------------------------------------------------
    # With every slot active this is EnvPool(backend="vmap") bit for bit:
    # the same reset split, carry-key chain and per-step splits.
    def reset(self, seed: int = 0) -> torch.Tensor:
        with self._cond:
            self._pending.clear()
            with self._on_stream():
                key = R.PRNGKey(seed, self.device)
                self._state, self._obs = adopt(self.venv.reset(key))
                self._key = R.fold_in(R.PRNGKey(seed, "cpu"),
                                      0x57EB).numpy().copy()
                self._active[:] = True
                # a copy: admit writes the table's obs in place
                return self._obs.clone()

    def step(self, actions) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     Dict]:
        with self._cond:  # the facade key chain is shared like _pending
            if self._key is None:
                raise RuntimeError("call reset() before step()")
            if not self._active.all():
                raise RuntimeError("lock-step facade needs every slot "
                                   "active; use send/recv with a partial "
                                   "session set")
            self._key, step_key = host_split(self._key)
        self.send(actions, np.arange(self.num_slots))
        obs, rew, done, info, _ = self.recv(key=step_key)
        return obs, rew, done, info

    def sample_actions(self, seed: int = 0) -> torch.Tensor:
        return sample_batch(self.action_space, R.PRNGKey(seed, self.device),
                            self.num_slots)


def _host_key(k) -> np.ndarray:
    k = np.asarray(k)
    if k.shape != (2,):
        raise ValueError(f"a key has shape (2,), not {k.shape}")
    return k.astype(np.int64)


__all__ = ["AsyncEnvPool", "AsyncUnsupportedError"]
