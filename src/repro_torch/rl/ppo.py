"""PPO on vectorised envs (port of `repro.rl.ppo`): the policy-gradient
learner of the toolkit.

An update collects `rollout_len` steps through the device-resident pool
(on `env_backend="cuda"` one megastep launch a step), then runs `epochs`
passes of clipped-surrogate minibatches over them. Everything stays on the
device and nothing reads a value back, so `train(fused=True)` can capture
updates into a CUDA graph (train/fused.py). Every random number is drawn
in the JAX package's order from the carried key (`categorical` for the
actions, `permutation` for the minibatches), so the port follows the JAX
trainer's trajectory: the golden `tests/golden/train_ppo_CartPole-v1.json`
holds both. The GAE reverse scan is a loop over the rollout and the
minibatch slices are static.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch import random as R
from repro_torch.core.env import Env
from repro_torch.device import resolve_device
from repro_torch.pool import PoolState, make_vec
from repro_torch.pool.envpool import _load_like
from repro_torch.rl.networks import Activation, mlp_apply, mlp_init
from repro_torch.train.optim import Adam, AdamState, value_and_grad


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    num_envs: int = 16
    rollout_len: int = 128
    epochs: int = 4
    minibatches: int = 4
    discount: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    units: Tuple[int, ...] = (64, 64)
    activation: str = "tanh"
    # the pool's step engine: "vmap", "cuda" (the megastep kernel) or
    # "torch" (its plain version); the JAX package's "pallas" is "cuda"
    env_backend: str = "vmap"


class ACParams(NamedTuple):
    torso: Any
    pi: Any
    vf: Any


def ac_init(key: torch.Tensor, obs_dim: int, n_actions: int,
            cfg: PPOConfig) -> ACParams:
    k1, k2, k3 = R.split(key, 3)
    torso = mlp_init(k1, (obs_dim,) + tuple(cfg.units))
    pi = mlp_init(k2, (cfg.units[-1], n_actions))
    vf = mlp_init(k3, (cfg.units[-1], 1))
    return ACParams(torso, pi, vf)


def ac_apply(params: ACParams, obs: torch.Tensor, activation: str = "tanh"):
    """(logits, value) of the actor-critic: the torso's last layer goes
    through tanh (elu for any other activation) before both heads."""
    h = mlp_apply(params.torso, obs, activation)
    h = torch.tanh(h) if activation == "tanh" else Activation["elu"](h)
    logits = mlp_apply(params.pi, h, activation)
    value = mlp_apply(params.vf, h, activation)[..., 0]
    return logits, value


def _make_pool(env: Env, cfg: PPOConfig, device):
    """The pool's pure handle on the configured step engine, built through
    `make_vec` (see rl/dqn._make_pool)."""
    return make_vec(env, cfg.num_envs, backend=cfg.env_backend,
                    device=device).xla()


class PPOState(NamedTuple):
    params: ACParams
    opt: AdamState
    pool: PoolState          # device-resident env pool carry (state + obs)
    key: torch.Tensor
    ep_return: torch.Tensor
    last_return: torch.Tensor


def ppo_init(env: Env, cfg: PPOConfig, key: torch.Tensor,
             device=None) -> PPOState:
    """The initial state on `device` (the CUDA card when None: raises
    without one)."""
    device = resolve_device(device)
    key, knet, kenv = R.split(key.to(device), 3)
    obs_dim = math.prod(env.observation_space.shape)
    params = ac_init(knet, obs_dim, env.action_space.n, cfg)
    pool = _make_pool(env, cfg, device)
    opt = Adam(lr=cfg.lr, clip_norm=cfg.max_grad_norm).init(params)
    # two buffers, not one shared: the fused trainer writes each carry
    # leaf in place
    zeros = lambda: torch.zeros(cfg.num_envs, dtype=torch.float32,
                                device=device)
    return PPOState(params, opt, pool.init(kenv), key, zeros(), zeros())


def _gae(rewards, values, dones, last_value, discount, lam):
    """Generalised advantage estimates (T, B), the reverse scan as a loop
    over T in the JAX package's arithmetic order."""
    v_next = torch.cat([values[1:], last_value[None]], 0)
    adv = torch.zeros_like(last_value)
    advs = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        r, v, d = rewards[t], values[t], dones[t]
        delta = r + discount * v_next[t] * (1 - d) - v
        adv = delta + discount * lam * (1 - d) * adv
        advs[t] = adv
    return torch.stack(advs)


def _log_softmax_at(logits: torch.Tensor, action: torch.Tensor):
    return torch.gather(F.log_softmax(logits, -1), -1,
                        action[:, None].long())[:, 0]


def ppo_loss(params: ACParams, batch, cfg: PPOConfig) -> torch.Tensor:
    """The clipped-surrogate loss of one minibatch `(obs, action,
    logp_old, adv, ret)`: policy, value (`vf_coef`) and entropy bonus
    (`ent_coef`) terms, in the JAX package's order."""
    obs, action, logp_old, adv, ret = batch
    logits, value = ac_apply(params, obs, cfg.activation)
    logp = _log_softmax_at(logits, action)
    ratio = torch.exp(logp - logp_old)
    pg = -torch.mean(torch.minimum(
        ratio * adv,
        torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv))
    vf = torch.mean((value - ret) ** 2)
    probs = F.softmax(logits, -1)
    ent = -torch.mean(torch.sum(probs * torch.log(probs + 1e-10), -1))
    return pg + cfg.vf_coef * vf - cfg.ent_coef * ent


def make_update_body(env: Env, cfg: PPOConfig, device=None):
    """The PPO update as one carry -> carry function, `update_body(state,
    lr=None) -> (state, metrics)`: collect `rollout_len` steps through the
    pool, then `epochs` passes of clipped-surrogate minibatches.

    `train` runs it host-alternating; train/fused.py captures it into a
    CUDA graph and passes a fleet row's `lr` (a 0-dim float32 tensor) to
    Adam. `lr=None` keeps `cfg.lr` bit for bit.
    """
    pool = _make_pool(env, cfg, resolve_device(device))
    n = cfg.rollout_len * cfg.num_envs
    mb = n // cfg.minibatches

    def collect(state: PPOState):
        ps, key = state.pool, state.key
        ep_ret, last_ret = state.ep_return, state.last_return
        traj = []
        for _ in range(cfg.rollout_len):
            key, k_act, k_env = R.split(key, 3)
            obs = ps.obs
            logits, value = ac_apply(state.params, obs, cfg.activation)
            action = R.categorical(k_act, logits)
            logp = _log_softmax_at(logits, action)
            ps, ts = pool.step(ps, action.to(torch.int32), k_env)
            # Bootstrap through time-limit cuts: a truncated step's value
            # target is r + γ·V(terminal_obs), folded into the stored
            # reward, so GAE's (1 - done) still cuts the trace at the
            # episode boundary. A stack without a TimeLimit skips it.
            if "truncated" in ts.info:
                trunc = ts.info["truncated"].to(torch.float32)
                term_obs = ts.info.get("terminal_obs", ts.obs)
                _, v_term = ac_apply(state.params, term_obs, cfg.activation)
                rew = ts.reward + cfg.discount * trunc * v_term
            else:
                rew = ts.reward
            ep_ret = ep_ret + ts.reward
            last_ret = torch.where(ts.done, ep_ret, last_ret)
            ep_ret = torch.where(ts.done, 0.0, ep_ret)
            traj.append((obs, action, logp, value, rew, ts.done))
        return (ps, key, ep_ret, last_ret), [torch.stack(x)
                                             for x in zip(*traj)]

    def update_body(state: PPOState, lr=None):
        optimizer = Adam(lr=cfg.lr if lr is None else lr,
                         clip_norm=cfg.max_grad_norm)
        (ps, key, ep_ret, last_ret), traj = collect(state)
        t_obs, t_act, t_logp, t_val, t_rew, t_done = traj
        _, last_value = ac_apply(state.params, ps.obs, cfg.activation)
        adv = _gae(t_rew, t_val, t_done.to(torch.float32), last_value,
                   cfg.discount, cfg.gae_lambda)
        ret = adv + t_val
        # the population std, as jnp.std takes it
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)

        flat = lambda x: x.reshape((n,) + tuple(x.shape[2:]))
        data = (flat(t_obs), flat(t_act), flat(t_logp), flat(adv), flat(ret))
        params, opt, epoch_losses = state.params, state.opt, []
        for _ in range(cfg.epochs):
            key, kperm = R.split(key)
            perm = R.permutation(kperm, n)
            shuffled = tuple(x[perm] for x in data)
            losses = []
            for i in range(cfg.minibatches):
                batch = tuple(x[i * mb:(i + 1) * mb] for x in shuffled)
                loss, grads = value_and_grad(
                    lambda p: ppo_loss(p, batch, cfg), params)
                params, opt = optimizer.update(grads, opt, params)
                losses.append(loss)
            epoch_losses.append(torch.stack(losses).mean())
        new_state = PPOState(params, opt, ps, key, ep_ret, last_ret)
        return new_state, {"loss": torch.stack(epoch_losses).mean(),
                           "return": last_ret.mean()}

    return update_body


def make_update(env: Env, cfg: PPOConfig, device=None):
    """The host-alternating update (the JAX package jits the body)."""
    return make_update_body(env, cfg, device)


def train(env: Env, cfg: PPOConfig, updates: int, key: torch.Tensor,
          fused: bool = False, chunk: int = 0, device=None):
    """PPO training on `device` (the CUDA card when None: raises without
    one). Returns (state, metrics dict of (updates,) tensors).

    `fused=True` runs the same update body through
    `train.fused.run_fused`: on the card, updates captured into a CUDA
    graph and replayed with the carry updated in place. The key chain
    rides the carry, so neither `fused` nor `chunk` moves the trajectory.
    """
    state = ppo_init(env, cfg, key, device)
    body = make_update_body(env, cfg, state.key.device)
    if fused:
        from repro_torch.train.fused import run_fused

        return run_fused(body, state, updates, chunk)
    history = []
    for _ in range(updates):
        state, metrics = body(state)
        history.append(metrics)
    return state, {k: torch.stack([m[k] for m in history])
                   for k in history[0]}


def state_from_numpy(src, env: Env, cfg: PPOConfig, device) -> PPOState:
    """A whole `PPOState` from the JAX package's `PPOState` as numpy
    leaves, read by field name (params, Adam, the pool carry, key as
    uint32), as `dqn.state_from_numpy` reads a `DQNState`."""
    template = ppo_init(env, cfg, R.PRNGKey(0), device)
    return _load_like(template, src, resolve_device(device))


__all__ = ["ACParams", "PPOConfig", "PPOState", "ac_apply", "ac_init",
           "make_update", "make_update_body", "ppo_init", "ppo_loss",
           "state_from_numpy", "train"]
