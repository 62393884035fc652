"""DQN — the paper's evaluation algorithm (§V-B/§V-C, hyperparams Table I);
port of `repro.rl.dqn`.

Two execution modes, matching the paper's comparison axis:
  - `train_compiled`: env stepping through the device-resident `EnvPool`
    (on `env_backend="cuda"` one megastep launch per training step, and on
    a pixel id the raster kernel's launches), replay and learning all on the
    device, the CaiRL execution model. The JAX package scans the step
    inside one compiled program; here each step is a sequence of launches
    from the host that never waits for the device: no `.item()`, no branch
    on a device value, the warm-up gate and the target sync as selects.
  - `train_host`: the same learner, but the environment is an interpreted
    host object stepped one transition at a time — the AI-Gym execution
    model. Fig. 2 compares the wall-clock of the two.

Every step draws its random numbers in the JAX package's order from the
carried key, so the port follows the JAX trainer's trajectory: the goldens
`tests/golden/train_dqn_*.json` hold both.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                 tree_unflatten)

from repro_torch import random as R
from repro_torch.core.env import Env
from repro_torch.device import resolve_device
from repro_torch.pool import PoolState, make_vec
from repro_torch.pool.envpool import _load_like
from repro_torch.rl.networks import (cnn_apply, cnn_init, f32_convs,
                                     mlp_apply, mlp_init)
from repro_torch.rl.replay import (ReplayState, replay_add_batch, replay_init,
                                   replay_sample)
from repro_torch.train.optim import Adam, AdamState, huber_loss, linear_schedule


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    """Defaults = paper Table I."""

    discount: float = 0.99
    units: Tuple[int, ...] = (32, 32)
    activation: str = "elu"
    batch_size: int = 32
    lr: float = 3e-4
    target_update_freq: int = 150
    memory_size: int = 50_000
    exploration_start: float = 1.0
    exploration_final: float = 0.01
    exploration_steps: int = 5_000
    network: str = "mlp"           # "mlp" (memory obs) | "cnn" (pixel obs)
    num_envs: int = 1
    learn_start: int = 100
    # the pool's step engine: "vmap", "cuda" (the megastep kernel) or
    # "torch" (its plain version)
    env_backend: str = "vmap"


class DQNState(NamedTuple):
    params: Any
    target: Any
    opt: AdamState
    replay: ReplayState
    pool: PoolState          # device-resident env pool carry (state + obs)
    key: torch.Tensor
    step: torch.Tensor
    ep_return: torch.Tensor  # (B,) running episodic return
    last_return: torch.Tensor  # (B,) most recent completed return


def _build_net(env: Env, cfg: DQNConfig, key: torch.Tensor):
    n_actions = env.action_space.n
    obs_shape = tuple(env.observation_space.shape)
    if cfg.network == "cnn":
        params = cnn_init(key, obs_shape, out=n_actions)
        apply_fn = lambda p, x: cnn_apply(p, x, cfg.activation)
    else:
        sizes = (math.prod(obs_shape),) + tuple(cfg.units) + (n_actions,)
        params = mlp_init(key, sizes)
        apply_fn = lambda p, x: mlp_apply(
            p, x.reshape(x.shape[:x.dim() - len(obs_shape)] + (-1,)),
            cfg.activation)
    return params, apply_fn


def _make_pool(env: Env, cfg: DQNConfig, device):
    """The pool's pure handle on the configured step engine, built through
    `make_vec`: env_backend="cuda" runs every env transition through the
    megastep kernel (one launch per train step) and raises where it cannot,
    as the pool does."""
    return make_vec(env, cfg.num_envs, backend=cfg.env_backend,
                    device=device).xla()


def dqn_init(env: Env, cfg: DQNConfig, key: torch.Tensor,
             device=None) -> Tuple[DQNState, Callable]:
    """The initial state on `device` (the CUDA card when None: raises
    without one): params, target, Adam state, replay ring, pool carry and
    key chain all live there."""
    device = resolve_device(device)
    key, knet, kenv = R.split(key.to(device), 3)
    params, apply_fn = _build_net(env, cfg, knet)
    pool = _make_pool(env, cfg, device)
    zeros = torch.zeros(cfg.num_envs, dtype=torch.float32, device=device)
    state = DQNState(
        params=params, target=tree_map(torch.clone, params),
        opt=Adam(lr=cfg.lr).init(params),
        replay=replay_init(cfg.memory_size, env.observation_space.shape,
                           device=device),
        pool=pool.init(kenv), key=key,
        step=torch.zeros((), dtype=torch.int32, device=device),
        ep_return=zeros, last_return=zeros.clone(),
    )
    return state, apply_fn


def _epsilon(cfg: DQNConfig, step):
    return linear_schedule(cfg.exploration_start, cfg.exploration_final,
                           cfg.exploration_steps)(step)


def _td_loss(apply_fn, params, target, batch, discount):
    """`terminal` is the stored env-termination flag — NOT folded `done`.

    A time-limit truncation is not a terminal state, so its transition is
    stored with terminal=0 and the target keeps bootstrapping from
    q(next_obs) (= q(terminal_obs), the pre-reset observation).
    """
    obs, action, reward, next_obs, terminal = batch
    q = apply_fn(params, obs)
    q_sa = torch.gather(q, -1, action[:, None].long())[:, 0]
    q_next = apply_fn(target, next_obs).amax(-1)
    tgt = reward + discount * (1.0 - terminal) * q_next.detach()
    return huber_loss(q_sa, tgt).mean()


def value_and_grad(loss_fn, params):
    """(loss, grads): `loss_fn(params)` and its gradients over the param
    tree, by `torch.autograd.grad` on detached copies of the leaves."""
    leaves, spec = tree_flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(leaves, spec))
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(list(grads), spec)


def make_learn_step(apply_fn, cfg: DQNConfig):
    """The learner update shared by both execution modes: the TD loss's
    value and gradients over the param tree, then Adam."""
    optimizer = Adam(lr=cfg.lr)

    def learn(params, target, opt, batch):
        loss_fn = lambda p: _td_loss(apply_fn, p, target, batch, cfg.discount)
        with f32_convs():    # the backward's convolutions too
            loss, grads = value_and_grad(loss_fn, params)
        params, opt = optimizer.update(grads, opt, params)
        return params, opt, loss

    return learn


def _select(pred, new, old):
    return tree_map(lambda n, o: torch.where(pred, n, o), new, old)


#: the profiler ranges of one training step, in the step's order: the
#: layers of the step, read by these names from a `torch.profiler` trace
STAGES = ("dqn::act", "dqn::pool_step", "dqn::replay", "dqn::learn",
          "dqn::select")


def make_train_step(env: Env, apply_fn, cfg: DQNConfig, device=None):
    """One environment-interaction + learn step, `step_fn(state) -> (state,
    metrics)`; `train_compiled` runs it `steps` times. Its layers run under
    the `STAGES` ranges.

    The ring in `state.replay` is written in place (see rl/replay.py).
    """
    pool = _make_pool(env, cfg, resolve_device(device))
    learn = make_learn_step(apply_fn, cfg)
    n_actions = env.action_space.n

    def step_fn(state: DQNState):
        with record_function("dqn::act"):
            key, k_eps, k_act, k_env, k_sample = R.split(state.key, 5)
            eps = _epsilon(cfg, state.step)
            obs = state.pool.obs
            q = apply_fn(state.params, obs)
            greedy = torch.argmax(q, dim=-1).to(torch.int32)
            randa = R.randint(k_act, (cfg.num_envs,), 0, n_actions)
            explore = R.uniform(k_eps, (cfg.num_envs,)) < eps
            action = torch.where(explore, randa, greedy)

        with record_function("dqn::pool_step"):
            new_pool, ts = pool.step(state.pool, action, k_env)

        with record_function("dqn::replay"):
            terminal_obs = ts.info.get("terminal_obs", ts.obs)
            # Store the *termination* flag, not the folded done: truncated
            # episodes still bootstrap through terminal_obs in _td_loss.
            terminal = ts.done
            if "truncated" in ts.info:
                terminal = terminal & ~ts.info["truncated"]
            replay = replay_add_batch(state.replay, obs, action, ts.reward,
                                      terminal_obs, terminal)
            batch = replay_sample(replay, k_sample, cfg.batch_size)

        # learn every step; the warm-up gate selects the result
        with record_function("dqn::learn"):
            new_params, new_opt, loss = learn(state.params, state.target,
                                              state.opt, batch)

        with record_function("dqn::select"):
            can_learn = replay.size >= cfg.learn_start
            params = _select(can_learn, new_params, state.params)
            opt = _select(can_learn, new_opt, state.opt)
            # periodic hard target sync (Table I: every 150 steps)
            sync = (state.step % cfg.target_update_freq) == 0
            target = _select(sync, params, state.target)

            ep_return = state.ep_return + ts.reward
            last_return = torch.where(ts.done, ep_return, state.last_return)
            ep_return = torch.where(ts.done, 0.0, ep_return)

        new_state = DQNState(params, target, opt, replay, new_pool, key,
                             state.step + 1, ep_return, last_return)
        metrics = {"loss": loss, "eps": eps, "return": last_return.mean()}
        return new_state, metrics

    return step_fn


def train_compiled(env: Env, cfg: DQNConfig, steps: int, key: torch.Tensor,
                   chunk: int = 0, fused: bool = False, device=None):
    """Full DQN training on the device. Returns (state, apply_fn, metrics
    dict of (T,) tensors).

    `chunk` groups the steps into dispatches of that many (full chunks and
    one remainder); the key chain lives in the state, so it never changes
    the result. `fused=True` (one donated program per chunk in the JAX
    package) comes with ROADMAP A10.
    """
    if fused:
        raise NotImplementedError("train_compiled(fused=True) comes with the "
                                  "fused trainer (ROADMAP A10)")
    state, apply_fn = dqn_init(env, cfg, key, device)
    step_fn = make_train_step(env, apply_fn, cfg, state.step.device)
    chunk = min(chunk or steps, steps)

    def run_chunk(state, n):
        ms = []
        for _ in range(n):
            state, m = step_fn(state)
            ms.append(m)
        return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    all_metrics = []
    done = 0
    while done < steps:  # full chunks + one remainder chunk — exactly `steps`
        n = min(chunk, steps - done)
        state, metrics = run_chunk(state, n)
        all_metrics.append(metrics)
        done += n
    metrics = {k: torch.cat([m[k] for m in all_metrics])
               for k in all_metrics[0]}
    return state, apply_fn, metrics


def train_host(make_env_host, env_spec_env: Env, cfg: DQNConfig, steps: int,
               key: torch.Tensor, seed: int = 0, device=None):
    """Same learner, interpreted host env (the AI-Gym execution model).

    `make_env_host()` builds the host env (`envs.baseline_python`); the
    learner lives on `device` (the CUDA card when None). Returns (params,
    completed episode returns).
    """
    device = resolve_device(device)
    host_env = make_env_host()
    host_env.seed(seed)
    key, knet = R.split(key.to(device))
    params, apply_fn = _build_net(env_spec_env, cfg, knet)
    target = tree_map(torch.clone, params)
    opt = Adam(lr=cfg.lr).init(params)
    replay = replay_init(cfg.memory_size, env_spec_env.observation_space.shape,
                         device=device)
    learn = make_learn_step(apply_fn, cfg)
    row = lambda x, dtype: torch.tensor(np.asarray([x]), dtype=dtype,
                                        device=device)

    rng = np.random.default_rng(seed)
    obs = np.asarray(host_env.reset(), np.float32)
    returns, ep_ret = [], 0.0
    for step in range(steps):
        eps = float(_epsilon(cfg, torch.tensor(step, dtype=torch.int32)))
        if rng.random() < eps:
            action = host_env.action_space_sample()
        else:
            q = apply_fn(params, torch.from_numpy(obs).to(device)[None])
            action = int(torch.argmax(q, dim=-1)[0])
        next_obs, reward, done, info = host_env.step(action)
        next_obs = np.asarray(next_obs, np.float32)
        # Same termination/truncation split as the compiled path.
        terminal = done and not info.get("truncated", False)
        replay = replay_add_batch(
            replay, row(obs, torch.float32), row(action, torch.int32),
            row(reward, torch.float32), row(next_obs, torch.float32),
            row(terminal, torch.float32))
        ep_ret += reward
        if done:
            returns.append(ep_ret)
            ep_ret = 0.0
            next_obs = np.asarray(host_env.reset(), np.float32)
        obs = next_obs
        if int(replay.size) >= cfg.learn_start:
            key, k_s = R.split(key)
            batch = replay_sample(replay, k_s, cfg.batch_size)
            params, opt, _ = learn(params, target, opt, batch)
        if step % cfg.target_update_freq == 0:
            target = tree_map(torch.clone, params)
    return params, returns


def greedy_returns(env: Env, apply_fn, params, key: torch.Tensor,
                   episodes: int = 8, max_steps: int = 500,
                   device=None) -> torch.Tensor:
    """Greedy evaluation over a batch of episodes, via a vmap pool on
    `device` (the CUDA card when None)."""
    device = resolve_device(device)
    pool = make_vec(env, episodes, backend="vmap", device=device).xla()
    key, rkey = R.split(key.to(device))
    ps = pool.init(rkey)
    finished = torch.zeros(episodes, dtype=torch.bool, device=device)
    rets = torch.zeros(episodes, dtype=torch.float32, device=device)
    for _ in range(max_steps):
        key, skey = R.split(key)
        action = torch.argmax(apply_fn(params, ps.obs), dim=-1).to(torch.int32)
        ps, ts = pool.step(ps, action, skey)
        rets = rets + ts.reward * ~finished
        finished = finished | ts.done
    return rets


def golden_checksums(env: Env, state: DQNState, apply_fn) -> dict:
    """A trained state reduced to the fields that the training goldens
    (tests/golden/train_dqn_*.json) hold: f64 sums of the params and the
    ring, the key, the ring's pointers, and greedy returns from key 123 on
    the state's device."""
    f64sum = lambda x: float(x.double().sum())
    leaves = tree_leaves(state.params)
    rets = greedy_returns(env, apply_fn, state.params, R.PRNGKey(123),
                          episodes=4, max_steps=100,
                          device=state.step.device)
    r = state.replay
    return {"param_sum": sum(f64sum(x) for x in leaves),
            "param_abs_sum": sum(f64sum(x.abs()) for x in leaves),
            "final_key": [int(v) for v in state.key],
            "last_return_mean": f64sum(state.last_return)
            / state.last_return.numel(),
            "eval_return_mean": float(rets.double().mean()),
            "replay_ptr": int(r.ptr), "replay_size": int(r.size),
            "replay_obs_sum": f64sum(r.obs),
            "replay_reward_sum": f64sum(r.reward),
            "replay_done_sum": f64sum(r.done)}


# -- carrying the JAX package's params and state across -----------------------

def params_from_numpy(tree, device) -> Any:
    """The JAX package's params as numpy arrays
    (`jax.tree.map(np.asarray, params)`) to tensors on `device`. The layouts
    are the same, so nothing is transposed."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def state_from_numpy(src, env: Env, cfg: DQNConfig, device) -> DQNState:
    """A whole `DQNState` from the JAX package's `DQNState` as numpy leaves,
    read by field name (params, Adam, replay, the pool carry as
    `EnvPool.load_state_dict` reads it, key as uint32)."""
    template, _ = dqn_init(env, cfg, R.PRNGKey(0), device)
    return _load_like(template, src, resolve_device(device))


__all__ = ["DQNConfig", "DQNState", "STAGES", "dqn_init", "golden_checksums",
           "greedy_returns", "make_learn_step", "make_train_step",
           "params_from_numpy", "state_from_numpy", "train_compiled",
           "train_host"]
