"""Device-resident ring replay buffer (port of `repro.rl.replay`).

The paper's DQN uses a 50 000-transition memory (Table I), kept on the
device so the sample→learn path never leaves it. `replay_add_batch` writes
the ring in place (`index_copy_`), the analogue of the JAX trainer's
donated carry: the returned state shares the ring's tensors with the one
given, so a caller that keeps an earlier state clones it first. `ptr` and
`size` stay 0-dim int32 tensors on the device, and nothing here reads one
back to the host.

The ring is a pure function of the transition stream, not of how the
stream is grouped into `replay_add_batch` calls, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch import random as R
from repro_torch.device import resolve_device


class ReplayState(NamedTuple):
    obs: torch.Tensor        # (cap, *obs_shape)
    action: torch.Tensor     # (cap, *act_shape)
    reward: torch.Tensor     # (cap,)
    next_obs: torch.Tensor   # (cap, *obs_shape)
    done: torch.Tensor       # (cap,)
    ptr: torch.Tensor        # ()
    size: torch.Tensor       # ()


def replay_init(capacity: int, obs_shape: Tuple[int, ...],
                act_shape: Tuple[int, ...] = (), act_dtype=torch.int32,
                device=None) -> ReplayState:
    """An empty ring on `device` (the CUDA card when None)."""
    device = resolve_device(device)
    zeros = lambda shape, dtype=torch.float32: torch.zeros(
        shape, dtype=dtype, device=device)
    return ReplayState(
        obs=zeros((capacity,) + tuple(obs_shape)),
        action=zeros((capacity,) + tuple(act_shape), act_dtype),
        reward=zeros((capacity,)),
        next_obs=zeros((capacity,) + tuple(obs_shape)),
        done=zeros((capacity,)),
        ptr=zeros((), torch.int32),
        size=zeros((), torch.int32),
    )


def replay_add_batch(state: ReplayState, obs, action, reward, next_obs,
                     done) -> ReplayState:
    """Insert a batch of B transitions at the ring pointer (wrapping), in
    place.

    When B > capacity the batch is truncated to its last `cap` transitions
    up front (ring semantics: later writes win; the dropped head would have
    been overwritten within this same call anyway). `ptr` still advances by
    the full B, as if every transition had been written.
    """
    cap = state.obs.shape[0]
    b = obs.shape[0]
    start = state.ptr
    if b > cap:
        drop = b - cap
        obs, action, reward, next_obs, done = (
            x[drop:] for x in (obs, action, reward, next_obs, done))
        start = state.ptr + drop
    idx = (start + torch.arange(min(b, cap), device=state.ptr.device)) % cap
    for ring, x in ((state.obs, obs), (state.action, action),
                    (state.reward, reward), (state.next_obs, next_obs),
                    (state.done, done)):
        ring.index_copy_(0, idx, x.to(ring.dtype))
    return state._replace(ptr=(state.ptr + b) % cap,
                          size=torch.clamp(state.size + b, max=cap))


def replay_sample(state: ReplayState, key: torch.Tensor, batch: int):
    """Uniform sample of `batch` transitions from the valid region."""
    idx = R.randint(key, (batch,), 0, torch.clamp(state.size, min=1))
    return tuple(x.index_select(0, idx) for x in (
        state.obs, state.action, state.reward, state.next_obs, state.done))


__all__ = ["ReplayState", "replay_add_batch", "replay_init", "replay_sample"]
