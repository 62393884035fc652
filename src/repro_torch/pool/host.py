"""HostPool (port of `repro.pool.host`): the interpreted-env pool behind
the same batched API.

The paper's JVM/Flash runners (and the pure-Python "AI Gym" baselines,
the port's own copy in envs/baseline_python) do not run on the device;
HostPool runs a batch of them on a thread pool behind the EnvPool-shaped
`reset()/step(actions)` API, so device and interpreted execution are
interchangeable in benchmarks and training harnesses (fig1/fig2
comparisons). It is numpy and threads only; nothing of it touches the card.

Async double-buffering: `send(actions)` dispatches one worker task per
env and returns immediately; `recv()` joins. A learner can therefore
overlap its device update (launches that release the GIL) with host env
stepping — EnvPool's async API shape. `step()` is send+recv.

Semantics mirror `Vec(AutoReset(env))`: envs auto-reset on done and the
pre-reset observation is surfaced as `info["terminal_obs"]`.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Union

import numpy as np

from repro_torch.runtime.straggler import StragglerTracker


class HostPool:
    """Thread-pooled batch of Gym-semantics host envs (reset/step/render).

    `env_factory` is a zero-arg callable returning an object with
    `seed(s)`, `reset() -> obs`, `step(a) -> (obs, r, done, info)` and
    `action_space_sample()` — the PythonRunner contract (core/runner.py) —
    or a registry id resolved through `envs.baseline_python.BASELINES`.

    Straggler telemetry: interpreted envs are exactly where per-lane step
    time varies (GC pauses, GIL contention, env-specific hot paths), so
    every worker step is timed into a runtime/straggler.StragglerTracker
    keyed by env index — `stragglers()` surfaces the profile/demote advice
    for lanes persistently slower than the batch median. The clock is
    injectable for deterministic tests.
    """

    def __init__(self, env_factory: Union[Callable, str], num_envs: int,
                 num_workers: Optional[int] = None, seed: int = 0,
                 tracker: Optional[StragglerTracker] = None,
                 clock: Optional[Callable[[], float]] = None):
        if isinstance(env_factory, str):
            from repro_torch.envs.baseline_python import BASELINES

            env_factory = BASELINES[env_factory]
        self.env_factory = env_factory
        self.num_envs = int(num_envs)
        self.tracker = tracker or StragglerTracker(num_hosts=self.num_envs)
        self._clock = clock or time.monotonic
        self._envs = [env_factory() for _ in range(self.num_envs)]
        workers = num_workers or min(self.num_envs, os.cpu_count() or 1)
        self._exec = ThreadPoolExecutor(max_workers=workers)
        self._pending = None
        self.seed(seed)

    def __len__(self) -> int:
        return self.num_envs

    def seed(self, seed: int) -> None:
        for i, env in enumerate(self._envs):
            env.seed(seed + i)

    # -- Gym-style batched API -------------------------------------------------
    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if self._pending is not None:  # join in-flight steps: envs are not
            for f in self._pending:    # safe to reset while workers mutate them
                f.result()
            self._pending = None
        if seed is not None:
            self.seed(seed)
        obs = list(self._exec.map(lambda e: np.asarray(e.reset(), np.float32),
                                  self._envs))
        return np.stack(obs)

    def send(self, actions) -> None:
        """Dispatch one step per env to the worker pool; non-blocking."""
        if self._pending is not None:
            raise RuntimeError("recv() the in-flight step before send()ing again")
        actions = np.asarray(actions)
        if actions.shape[0] != self.num_envs:
            raise ValueError(f"actions batch {actions.shape[0]} != {self.num_envs} envs")
        self._pending = [self._exec.submit(self._step_one, i, env, a)
                         for i, (env, a) in enumerate(zip(self._envs,
                                                          actions))]

    def recv(self):
        """Join the in-flight step: (obs, reward, done, info)."""
        if self._pending is None:
            raise RuntimeError("send() actions before recv()")
        results = [f.result() for f in self._pending]
        self._pending = None
        obs, reward, done, terminal = (np.stack(x) for x in zip(*results))
        return obs, reward, done, {"terminal_obs": terminal}

    def step(self, actions):
        self.send(actions)
        return self.recv()

    def _step_one(self, idx, env, action):
        if isinstance(action, np.ndarray) and action.ndim == 0:
            action = action.item()
        t0 = self._clock()
        obs, reward, done, _ = env.step(action)
        terminal = np.asarray(obs, np.float32)
        if done:
            obs = env.reset()
        # per-lane step time -> straggler EWMA (tracker.record is a dict
        # write per key; lanes never share a key, so no lock needed)
        self.tracker.record(idx, self._clock() - t0)
        return (np.asarray(obs, np.float32), np.float32(reward), bool(done),
                terminal)

    def stragglers(self):
        """StragglerReports for lanes persistently above the median step
        time (advice: "profile", then "demote" after `patience` strikes)."""
        return self.tracker.reports()

    # -- random-policy harness (PythonRunner parity) ----------------------------
    def run_random(self, num_steps: int, seed: int = 0, render: bool = False):
        """Per-env random rollout, one worker each; == PythonRunner.run per env.

        Returns (total_reward (B,), episodes (B,)). Env i uses seed+i, so
        a 1-env pool reproduces `PythonRunner(factory).run(n, seed=seed)`
        exactly.
        """
        futs = [self._exec.submit(self._run_one, env, num_steps, seed + i, render)
                for i, env in enumerate(self._envs)]
        totals, episodes = zip(*(f.result() for f in futs))
        return np.asarray(totals, np.float32), np.asarray(episodes, np.int32)

    @staticmethod
    def _run_one(env, num_steps: int, seed: int, render: bool):
        env.seed(seed)
        env.reset()
        total, episodes = 0.0, 0
        for _ in range(num_steps):
            _, r, done, _ = env.step(env.action_space_sample())
            if render:
                env.render()
            total += r
            if done:
                episodes += 1
                env.reset()
        return total, episodes

    def close(self) -> None:
        self._exec.shutdown(wait=False)


__all__ = ["HostPool"]
