"""Rollout runners (port of `repro.core.runner`): the paper's `run()` fast
path (§III-B).

The paper: "The interpreter overhead can be reduced by ... implementing a
run function, notably eliminating the need for interpreted loop code in
Python." Here a runner is a loop of batched device launches that never
reads a value back: no `.item()`, no branch on a device value, so the host
only queues work.

  - `rollout`             : policy-driven rollout (autoreset inside)
  - `rollout_random`      : `action_space.sample`-driven (Listing 1/2's
                            benchmark loop), optionally rendering every frame
  - `rollout_random_fast` : the same with one `fold_in` per step and one
                            batched action draw (the pools' key recipe)
  - `episode_return`      : one evaluation episode
  - `PythonRunner`        : host runner for interpreted envs (the paper's
                            foreign runtimes; the AI-Gym baselines)

The port's envs are batch-native, so where the JAX package `vmap`s a
single-lane policy over lane keys, `rollout`'s policy takes the whole batch:
`policy(params, obs (B, ...), keys (B, 2)) -> actions (B, ...)`, the keys
being `split(akey, B)`, the lane keys JAX's `vmap` hands out one by one.
Each device runner runs on `device`, the CUDA card when None (raising
without one), and moves the key there; `policy_params` are the caller's
to place.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import random as R
from repro_torch.core.env import Env
from repro_torch.core.spaces import sample_batch
from repro_torch.core.wrappers import AutoReset, Vec
from repro_torch.device import resolve_device


class Trajectory(NamedTuple):
    obs: torch.Tensor       # (T, B, ...) observation seen before acting
    action: torch.Tensor    # (T, B, ...)
    reward: torch.Tensor    # (T, B)
    done: torch.Tensor      # (T, B)
    next_obs: torch.Tensor  # (T, B, ...) post-step obs (the pre-reset
    #                         terminal obs where an episode ended)


def _batched(env: Env, batch_size: int) -> Env:
    return Vec(AutoReset(env), batch_size)


def rollout(env: Env, policy: Callable[[Any, torch.Tensor, torch.Tensor],
                                       torch.Tensor],
            policy_params: Any, num_steps: int, batch_size: int,
            key: torch.Tensor, device=None) -> Trajectory:
    """`num_steps` steps of `batch_size` autoresetting envs under `policy`
    (see the module doc for its batched contract)."""
    venv = _batched(env, batch_size)
    key, rkey = R.split(key.to(resolve_device(device)))
    state, obs = venv.reset(rkey)
    outs = []
    for _ in range(num_steps):
        key, akey, skey = R.split(key, 3)
        action = policy(policy_params, obs, R.split(akey, batch_size))
        ts = venv.step(state, action, skey)
        outs.append((obs, action, ts.reward, ts.done,
                     ts.info.get("terminal_obs", ts.obs)))
        state, obs = ts.state, ts.obs
    return Trajectory(*(torch.stack(x) for x in zip(*outs)))


def _render_or_zeros(venv, state, render, batch_size, device):
    if render:
        return venv.render(state)
    return torch.zeros(batch_size, dtype=torch.float32, device=device)


def rollout_random(env: Env, key: torch.Tensor, num_steps: int,
                   batch_size: int = 1, render: bool = False, device=None):
    """The paper's benchmark loop (Listing 1/2): random actions, rendering
    every frame when `render`. Returns (sum_reward (B,), episodes (B,),
    the last frame (B, H, W), or zeros (B,) without `render`)."""
    venv = _batched(env, batch_size)
    key, rkey = R.split(key.to(resolve_device(device)))
    state, _ = venv.reset(rkey)
    frame = _render_or_zeros(venv, state, render, batch_size, key.device)
    rew = torch.zeros(batch_size, dtype=torch.float32, device=key.device)
    eps = torch.zeros(batch_size, dtype=torch.int32, device=key.device)
    for _ in range(num_steps):
        key, akey, skey = R.split(key, 3)
        ts = venv.step(state, venv.sample_actions(akey), skey)
        state = ts.state
        if render:
            frame = venv.render(state)
        rew = rew + ts.reward
        eps = eps + ts.done.to(torch.int32)
    return rew, eps, frame


def rollout_random_fast(env: Env, key: torch.Tensor, num_steps: int,
                        batch_size: int = 1, render: bool = False,
                        device=None):
    """`rollout_random`'s semantics with less RNG: one `fold_in(key, i)` a
    step, shared by the batched action draw and the step (the pools'
    recipe, so the two stay comparable), the env reset from
    `fold_in(key, 0x5EED)`."""
    venv = _batched(env, batch_size)
    key = key.to(resolve_device(device))
    state, _ = venv.reset(R.fold_in(key, 0x5EED))
    frame = _render_or_zeros(venv, state, render, batch_size, key.device)
    rew = torch.zeros(batch_size, dtype=torch.float32, device=key.device)
    eps = torch.zeros(batch_size, dtype=torch.int32, device=key.device)
    for i in range(1, num_steps + 1):
        k = R.fold_in(key, i)
        # repro: allow[key-reuse] the pools' chain: the action draw and the step share the step key, so runner and pool rollouts stay comparable
        ts = venv.step(state, sample_batch(env.action_space, k, batch_size), k)
        state = ts.state
        if render:
            frame = venv.render(state)
        rew = rew + ts.reward
        eps = eps + ts.done.to(torch.int32)
    return rew, eps, frame


class PythonRunner:
    """Host-side runner for interpreted envs (the paper's foreign runtimes).

    Drives any object with Gym semantics (`seed(s)`, `reset() -> obs`,
    `step(a) -> (obs, r, done, info)`, `action_space_sample()`, optional
    `render()`): the pure-Python baselines (envs/baseline_python) run
    under the same harness for the Fig. 1/2 comparisons.
    """

    def __init__(self, env_factory: Callable[[], Any]):
        self.env_factory = env_factory

    def run(self, num_steps: int, render: bool = False, seed: int = 0):
        env = self.env_factory()
        env.seed(seed)
        env.reset()
        total_r, episodes = 0.0, 0
        for _ in range(num_steps):
            _, r, done, _ = env.step(env.action_space_sample())
            if render:
                env.render()
            total_r += r
            if done:
                episodes += 1
                env.reset()
        return total_r, episodes


def episode_return(env: Env, policy, policy_params, key: torch.Tensor,
                   max_steps: int = 1000, device=None):
    """One evaluation episode of a single-lane env: (return, steps) as
    0-dim tensors. `policy(params, obs, key (2,))` acts for the lane.

    The JAX package's `while_loop` stops at the episode's end; here all
    `max_steps` steps are queued with no read-back, and a step after the
    end changes neither the return nor the step count, so both are the
    JAX package's.
    """
    key, rkey = R.split(key.to(resolve_device(device)))
    state, obs = env.reset(rkey)
    ret = torch.zeros((), dtype=torch.float32, device=key.device)
    done = torch.zeros((), dtype=torch.bool, device=key.device)
    steps = torch.zeros((), dtype=torch.int32, device=key.device)
    for _ in range(max_steps):
        key, akey, skey = R.split(key, 3)
        ts = env.step(state, policy(policy_params, obs, akey), skey)
        # a select, not ret + reward * (1 - done): a lane stepped past its
        # end may hold non-finite values
        ret = torch.where(done, ret, ret + ts.reward)
        steps = steps + (~done).to(torch.int32)
        done = done | ts.done
        state, obs = ts.state, ts.obs
    return ret, steps


__all__ = ["PythonRunner", "Trajectory", "episode_return", "rollout",
           "rollout_random", "rollout_random_fast"]
