"""Fused on-device training and multi-seed fleets (port of
`repro.train.fused`).

A train step (`rl/dqn.make_train_step`, `rl/ppo.make_update_body`) is a
carry -> carry function whose env interaction runs through the
device-resident pool and which never reads a value back. The JAX package
scans K of them into one compiled program whose carry is donated. The
port's counterpart is a CUDA graph:

  - On a CUDA device, `fused_train_chunk(step_fn)` captures a *unit* of
    `UNIT_STEPS` consecutive steps once with `torch.cuda.graph` and replays
    it. The captured steps read the carry from static buffers, and at the
    end of the unit each new carry leaf is copied into its buffer: the
    carry is updated in place, the port's donation. A leaf the step already
    writes in place (the replay ring, rl/replay.py) is its own buffer and
    is not copied, so the 11.29 GB ring of the Pong-v0 CNN exists once. A
    chunk of n steps is n replays of the one-step unit, so every chunk
    length replays the same graph. Each step's metrics go to a static
    slot, and after each replay one device copy moves the slot into the
    chunk's (n, ...) output: no host sync anywhere in the loop.
  - Before the first capture, `WARMUP_STEPS` steps run eagerly on the
    capture stream: they build the kernels, set up cuBLAS and cuDNN on that
    stream and load the modules, none of which may happen while capturing.
    They are steps of the chunk, on its carry, so the carry advances
    exactly n steps and nothing of it is copied (a copy would double the
    Pong-v0 ring).
  - On the CPU (only when the caller names it) the same steps run as a
    plain loop: the plain version the tests hold. It never runs on the card.
  - Failures raise: a capture that fails (a step that syncs or copies from
    the host while capturing) raises, and nothing falls back to the eager
    loop.

The kernels' launch counters count at capture, not at replay, so the
runner takes each graph's captured launches off the counts and adds them
back once per replay: the counts are launches made on the card.

Key-chain pinning: every random number a step draws is split from the key
in the carry, so the trajectory does not depend on `chunk` or on the
capture unit, and DQN's fused and host-alternating runs agree bit for bit.

Fleets: F separate carries, each built by its algorithm's init from
`PRNGKey(seed[f])`, stepped together (every row's steps captured in one
graph unit) with row f's learning rate, so row f is the solo run with
`seed[f]` and `lr[f]` by construction. The result is stacked into the
(F, ...) states and (F, steps) metrics the JAX package returns.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, NamedTuple, Union

import torch
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                 tree_unflatten)

from repro_torch import random as R
from repro_torch.core.env import Env
from repro_torch.core.registry import make as registry_make
from repro_torch.device import resolve_device

#: the training configurations pinned by committed goldens
#: (tests/golden/train_<algo>_<env>.json) — "<algo>/<env_id>"
GOLDEN_TRAIN_IDS = ("dqn/CartPole-v1", "dqn/FrozenLake-v0", "ppo/CartPole-v1")

#: steps captured in one CUDA graph unit. On an H100 80GB HBM3 at 700 W
#: (chip_smoke.py's `phase_unit_sweep`, 3 rounds; PERF.md §6), a
#: replayed PPOConfig() update took 87.38 ms at a unit of 1 and 87.46 to
#: 87.68 at 2, 4 and 8; a Table I step 2.197 ms at 1, 2.164 to 2.177 at 2
#: to 8 and 2.41 to 2.46 at 16 and 32. The capture grows with the unit
#: (0.065 s a Table I step, 1.9 s a PPO update), and a unit of one step
#: fits every chunk length with one graph.
UNIT_STEPS = 1
#: eager steps before the first capture (see the module doc)
WARMUP_STEPS = 1


# -- the fused chunk runner ---------------------------------------------------

def _storage(x: torch.Tensor) -> int:
    return x.untyped_storage().data_ptr()


def _donate_safe(carry):
    """Copy carry leaves that share memory with an earlier leaf. An init
    may hand one tensor (or views of one buffer) to several carry slots,
    but the fused runner writes every slot in place, so each needs its own
    buffer."""
    seen = set()

    def dedupe(x):
        if isinstance(x, torch.Tensor) and x.numel():
            if _storage(x) in seen:
                return x.clone()
            seen.add(_storage(x))
        return x

    return tree_map(dedupe, carry)


class _Packed(NamedTuple):
    """Where each metric lies in a step's packed metric row."""

    keys: tuple
    shapes: tuple
    bounds: tuple       # (start, stop) per key


def _pack(metrics_per_step):
    """[{key: tensor}] -> ((steps, width) tensor, _Packed)."""
    first = metrics_per_step[0]
    dtypes = {v.dtype for v in first.values()}
    if len(dtypes) != 1:
        raise ValueError(f"the fused runner packs metrics of one dtype; got "
                         f"{ {k: v.dtype for k, v in first.items()} }")
    keys = tuple(first)
    shapes = tuple(tuple(first[k].shape) for k in keys)
    bounds, start = [], 0
    for k in keys:
        bounds.append((start, start + first[k].numel()))
        start += first[k].numel()
    rows = [torch.cat([m[k].reshape(-1) for k in keys])
            for m in metrics_per_step]
    return torch.stack(rows), _Packed(keys, shapes, tuple(bounds))


def _unpack(out: torch.Tensor, layout: _Packed) -> Dict[str, torch.Tensor]:
    n = out.shape[0]
    return {k: out[:, a:b].reshape((n,) + shape)
            for k, shape, (a, b) in zip(layout.keys, layout.shapes,
                                        layout.bounds)}


def _counters():
    from repro_torch.kernels import launch_counters

    return launch_counters()


def _plain_chunk(step_fn, carry, n):
    ms = []
    for _ in range(n):
        carry, m = step_fn(carry)
        ms.append(m)
    return carry, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}


class _GraphRunner:
    """The CUDA-graph runner of one carry: its static buffers, the graph of
    `unit` steps captured from them, and what the capture cost. The unit
    is `UNIT_STEPS` but for `phase_unit_sweep`, which measures others."""

    def __init__(self, step_fn: Callable, unit: int = UNIT_STEPS):
        self.step_fn = step_fn
        self.unit = unit
        self.buffers = None
        self.spec = None
        self.graph = None       # (CUDAGraph, metric slot, captured launches)
        self.stream = None
        self.mempool = None
        self.layout = None
        #: the capture's seconds and captured launches; the number of
        #: replays and of eager warm-up steps
        self.stats = {"capture": None, "replays": 0, "warmup_steps": 0}

    def _bound(self, leaves) -> bool:
        return self.buffers is not None and len(leaves) == len(
            self.buffers) and all(a is b for a, b in zip(leaves,
                                                         self.buffers))

    def _adopt(self, carry) -> None:
        """The carry's leaves become the static buffers (no copy)."""
        carry = _donate_safe(carry)
        self.buffers, self.spec = tree_flatten(carry)
        self.graph = None
        self.mempool = torch.cuda.graph_pool_handle()

    def _capture(self):
        """Capture `unit` steps from the static buffers, ending with the
        copies of the new carry into them."""
        counters = _counters()
        before = {k: fn.launches for k, fn in counters.items()}
        graph = torch.cuda.CUDAGraph()
        # the capture synchronises first; the wait for queued replays is
        # not capture time
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # a CUDA graph that the collector destroys mid-capture (one held in
        # a reference cycle) would invalidate the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.mempool,
                                  stream=self.stream):
                carry = tree_unflatten(self.buffers, self.spec)
                ms = []
                for _ in range(self.unit):
                    carry, m = self.step_fn(carry)
                    ms.append(m)
                new, spec = tree_flatten(carry)
                if spec != self.spec:
                    raise ValueError("a train step changed the structure of "
                                     "its carry")
                self._write_back(new)
                slot, layout = _pack(ms)
        except Exception as e:
            raise RuntimeError(f"capturing {self.unit} train steps into a "
                               f"CUDA graph failed: {e}") from e
        finally:
            if collecting:
                gc.enable()
            captured = {k: fn.launches - before[k]
                        for k, fn in counters.items()}
            for k, fn in counters.items():
                fn.launches = before[k]
        if self.layout is not None and layout != self.layout:
            raise ValueError("a train step changed its metrics")
        self.layout = layout
        self.stats["capture"] = {
            "seconds": time.perf_counter() - t0,
            "launches": {k: v for k, v in captured.items() if v}}
        self.graph = (graph, slot, captured)
        return self.graph

    def _write_back(self, new) -> None:
        """Copy each new leaf into its buffer. A leaf the step wrote in
        place is its buffer already; a new leaf that lies in another
        buffer's memory is cloned before any buffer is written."""
        static = {_storage(b) for b in self.buffers if b.numel()}
        srcs = []
        for dst, src in zip(self.buffers, new):
            if (src.shape, src.dtype) != (dst.shape, dst.dtype):
                raise ValueError(f"a carry leaf changed from {dst.dtype}"
                                 f"{tuple(dst.shape)} to {src.dtype}"
                                 f"{tuple(src.shape)}")
            if src is dst or (src.data_ptr() == dst.data_ptr()
                              and src.stride() == dst.stride()):
                srcs.append(None)
            elif src.numel() and _storage(src) in static:
                srcs.append(src.clone())
            else:
                srcs.append(src)
        for dst, src in zip(self.buffers, srcs):
            if src is not None:
                dst.copy_(src)

    def _warmup(self, carry, steps):
        ms = []
        for _ in range(steps):
            carry, m = self.step_fn(carry)
            ms.append(m)
        self.stats["warmup_steps"] += steps
        return carry, ms

    def __call__(self, carry, n: int):
        device = tree_leaves(carry)[0].device
        current = torch.cuda.current_stream(device)
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        self.stream.wait_stream(current)
        warm_steps = 0 if self._bound(tree_leaves(carry)) else min(
            WARMUP_STEPS, n)
        if (n - warm_steps) % self.unit:
            raise ValueError(f"{n - warm_steps} steps after the warm-up are "
                             f"not whole units of {self.unit}")
        with torch.cuda.stream(self.stream):
            warm = []
            if warm_steps:
                carry, warm = self._warmup(carry, warm_steps)
                self._adopt(carry)
            out = None
            if warm:
                rows, self.layout = _pack(warm)
                out = torch.empty((n,) + tuple(rows.shape[1:]),
                                  dtype=rows.dtype, device=device)
                out[:len(warm)].copy_(rows)
            counters = _counters()
            for done in range(len(warm), n, self.unit):
                graph, slot, captured = self.graph or self._capture()
                graph.replay()
                if out is None:
                    out = torch.empty((n,) + tuple(slot.shape[1:]),
                                      dtype=slot.dtype, device=device)
                out[done:done + self.unit].copy_(slot)
                for k, fn in counters.items():
                    fn.launches += captured[k]
                self.stats["replays"] += 1
        current.wait_stream(self.stream)
        return tree_unflatten(self.buffers, self.spec), _unpack(out,
                                                                self.layout)


def fused_train_chunk(step_fn: Callable) -> Callable:
    """`run_chunk(carry, n) -> (carry, metrics)`: `n` steps of
    `step_fn(carry) -> (carry, metrics)` as CUDA-graph replays on a CUDA
    carry (see the module doc), as a plain loop on a CPU carry. Metrics
    come back stacked (n, ...).

    On the card the input carry is consumed: its leaves become the graphs'
    static buffers and are overwritten; keep using the *returned* carry,
    which is those buffers, so the next call replays without rebinding.
    `run_chunk.stats` holds the capture's seconds and launches.
    """
    runner = _GraphRunner(step_fn)

    def run_chunk(carry, n: int):
        if tree_leaves(carry)[0].device.type == "cuda":
            return runner(carry, n)
        return _plain_chunk(step_fn, carry, n)

    run_chunk.stats = runner.stats
    return run_chunk


def _chunks(run_chunk, state, steps, chunk):
    """Full chunks plus one remainder chunk, exactly `steps` steps;
    metrics concatenated on the step axis."""
    chunk = min(chunk or steps, steps)
    all_metrics, done = [], 0
    while done < steps:
        n = min(chunk, steps - done)
        state, metrics = run_chunk(state, n)
        all_metrics.append(metrics)
        done += n
    return state, {k: torch.cat([m[k] for m in all_metrics])
                   for k in all_metrics[0]}


def run_fused(step_fn: Callable, state, steps: int, chunk: int = 0):
    """Drive `steps` train steps through fused chunks of `chunk` (0: one
    chunk). The key chain lives in the carry, so the trajectory does not
    depend on `chunk`; metrics come back stacked (steps, ...) like the
    host-alternating loop's."""
    run_chunk = fused_train_chunk(step_fn)
    return _chunks(run_chunk, _donate_safe(state), steps, chunk)


# -- multi-seed / multi-hparam fleets -----------------------------------------

class Fleet(NamedTuple):
    """One row per experiment; tensors aligned on the fleet axis (F,)."""

    seed: torch.Tensor   # (F,) int32 — PRNGKey(seed[f]) seeds row f
    lr: torch.Tensor     # (F,) float32 — row f's Adam learning rate

    @property
    def width(self) -> int:
        return int(self.seed.shape[0])


def fleet_grid(seeds, lrs) -> Fleet:
    """Cartesian product seeds × lrs as aligned Fleet rows (row-major)."""
    s = torch.as_tensor(seeds, dtype=torch.int32).reshape(-1)
    lr = torch.as_tensor(lrs, dtype=torch.float32).reshape(-1)
    return Fleet(s.repeat_interleave(len(lr)), lr.repeat(len(s)))


def _as_fleet(grid, default_lr: float) -> Fleet:
    """Normalise a grid spec: a Fleet, a {"seeds": .., "lrs": ..} dict
    (cartesian product; lrs defaults to the config's lr), or a seed list."""
    if isinstance(grid, Fleet):
        return Fleet(torch.as_tensor(grid.seed, dtype=torch.int32),
                     torch.as_tensor(grid.lr, dtype=torch.float32))
    if isinstance(grid, dict):
        unknown = set(grid) - {"seeds", "lrs"}
        if unknown:
            raise TypeError(f"unknown fleet grid keys {sorted(unknown)}; "
                            "expected 'seeds' and/or 'lrs'")
        return fleet_grid(grid.get("seeds", [0]), grid.get("lrs",
                                                           [default_lr]))
    seeds = torch.as_tensor(grid, dtype=torch.int32)
    return Fleet(seeds, torch.full(seeds.shape, default_lr,
                                   dtype=torch.float32))


def _algo_parts(env: Env, algo: str, cfg, device):
    """(cfg, init_row(key) -> state, step_fn(state, lr=None) -> (state,
    metrics)) of an algorithm on `device`."""
    if algo == "dqn":
        from repro_torch.rl import dqn as _dqn

        cfg = cfg or _dqn.DQNConfig()
        _, apply_fn = _dqn._build_net(env, cfg, R.PRNGKey(0, device))
        step_fn = _dqn.make_train_step(env, apply_fn, cfg, device)
        init_row = lambda key: _dqn.dqn_init(env, cfg, key, device)[0]
        return cfg, init_row, step_fn
    if algo == "ppo":
        from repro_torch.rl import ppo as _ppo

        cfg = cfg or _ppo.PPOConfig()
        body = _ppo.make_update_body(env, cfg, device)
        init_row = lambda key: _ppo.ppo_init(env, cfg, key, device)
        return cfg, init_row, body
    raise ValueError(f"unknown fleet algo {algo!r}; expected 'dqn' or 'ppo'")


def fleet(env: Union[Env, str], grid, steps: int, *, algo: str = "dqn",
          cfg=None, chunk: int = 0, device=None):
    """Train a whole seeds × lr fleet on `device` (the CUDA card when None;
    raises without one).

    `grid` is a `Fleet`, a `{"seeds": [...], "lrs": [...]}` dict (cartesian
    product) or a plain seed list. On the card every row's steps are
    captured into one graph unit and replayed (see the module doc).

    Row f equals the solo `train_compiled(env, replace(cfg, lr=lr[f]),
    steps, PRNGKey(seed[f]))` run (or `ppo.train`) bit for bit: each row
    is its own carry, and its learning rate reaches Adam as a 0-dim
    float32 tensor, which rounds as the solo run's Python float does.

    Returns `(states, metrics)` with a leading (F,) fleet axis; DQN metrics
    are (F, steps), PPO metrics (F, updates).
    """
    device = resolve_device(device)
    if isinstance(env, str):
        env = registry_make(env)
    cfg, init_row, step_fn = _algo_parts(env, algo, cfg, device)
    fl = _as_fleet(grid, cfg.lr)
    rows = tuple(init_row(R.PRNGKey(int(s), device)) for s in fl.seed)
    lrs = [fl.lr[f].to(device) for f in range(fl.width)]

    def fleet_step(carries):
        new, ms = [], []
        for carry, lr in zip(carries, lrs):
            carry, m = step_fn(carry, lr=lr)
            new.append(carry)
            ms.append(m)
        return tuple(new), {k: torch.stack([m[k] for m in ms])
                            for k in ms[0]}

    carries, metrics = run_fused(fleet_step, rows, steps, chunk)
    states = tree_map(lambda *xs: torch.stack(xs), *carries)
    return states, {k: v.transpose(0, 1) for k, v in metrics.items()}


# -- golden training configurations (tests and chip_smoke.py share these) ------

def golden_train_setup(gid: str):
    """(algo, env_id, cfg, steps) for a committed training-golden id.

    Small but adversarial configs: the DQN ring (96) wraps inside the
    64-step run (128 transitions), learning starts mid-run, epsilon decays
    across it and the target net re-syncs on a non-divisor period.
    """
    if gid not in GOLDEN_TRAIN_IDS:
        raise KeyError(f"unknown golden train id {gid!r}; expected one of "
                       f"{GOLDEN_TRAIN_IDS}")
    algo, env_id = gid.split("/")
    if algo == "dqn":
        from repro_torch.rl.dqn import DQNConfig

        cfg = DQNConfig(num_envs=2, memory_size=96, learn_start=16,
                        batch_size=8, exploration_steps=48,
                        target_update_freq=13)
        return algo, env_id, cfg, 64
    from repro_torch.rl.ppo import PPOConfig

    # 4 updates × 16-step rollouts = 64 env steps per env
    cfg = PPOConfig(num_envs=4, rollout_len=16, epochs=2, minibatches=2)
    return algo, env_id, cfg, 4


__all__ = ["Fleet", "GOLDEN_TRAIN_IDS", "fleet", "fleet_grid",
           "fused_train_chunk", "golden_train_setup", "run_fused"]
