"""Snake with a fixed procedural food chain, batch-native (port of
`repro.envs.grid.snake`; same operation order, constants copied).

The body is a per-cell age grid (a cell holds the steps until that segment
leaves it; the head cell holds the length), so the game is element-wise
arithmetic over the board. `step` draws no random numbers: `reset` draws a
per-cell priority field `prio`, and the k-th food appears at the free cell
that minimises frac(prio + k·φ). Rewards: +1 eat, -1 death (wall or body),
0 otherwise; the episode also ends when the body fills the board. The
observation is the cell-code grid, `MultiDiscrete`: 0 empty, 1 body, 2
head, 3 food. The CUDA body in csrc/megastep.cu repeats `step` and `reset`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random as R
from repro_torch.core.env import Env, Timestep
from repro_torch.core.spaces import Discrete, MultiDiscrete
from repro_torch.envs.grid.common import grid_scene, move_deltas
from repro_torch.numerics import f32

PHI = 0.6180339887498949   # golden-ratio conjugate: the food hop per eat
EAT_REWARD = 1.0
DEATH_REWARD = -1.0
INTENS = (0.0, 0.55, 1.0, 0.8)   # empty, body, head, food


class SnakeState(NamedTuple):
    ages: torch.Tensor    # (..., n*n) int32: 0 empty, else steps to vacate
    head: torch.Tensor    # (...,) int32 cell index
    food: torch.Tensor    # (...,) int32 cell index
    length: torch.Tensor  # (...,) int32
    eaten: torch.Tensor   # (...,) int32: k, the index into the food chain
    prio: torch.Tensor    # (..., n*n) float32: this episode's food priorities


def place_food(prio, ages, head, k):
    """The free cell minimising frac(prio + k·φ), ties to the lowest index.

    prio (..., m) float32, ages (..., m) int32, head and k (...,) int32.
    φ is rounded to float32 once and the product and the sum are rounded
    apart, as the JAX package's unfused ops round them.
    """
    m = prio.shape[-1]
    idx = torch.arange(m, device=prio.device)
    vals = prio + k.to(torch.float32).unsqueeze(-1) * f32(PHI)
    vals = vals - torch.floor(vals)
    free = (ages == 0) & (idx != head.unsqueeze(-1))
    v = vals.masked_fill(~free, 2.0)
    at_min = v == v.min(-1, keepdim=True).values
    return torch.where(at_min, idx.to(torch.int32), m).min(-1).values


class Snake(Env):
    def __init__(self, n: int = 6):
        self.n = n
        self.m = n * n
        self.observation_space = MultiDiscrete((4,) * self.m)
        self.action_space = Discrete(4)
        self.frame_shape = (84, 84)
        self.reward_range = (DEATH_REWARD, EAT_REWARD)

    def reset(self, keys):
        center = (self.n // 2) * self.n + self.n // 2
        prio = R.uniform(keys, (self.m,))
        lead, dev = keys.shape[:-1], keys.device
        head = torch.full(lead, center, dtype=torch.int32, device=dev)
        ages = torch.zeros(lead + (self.m,), dtype=torch.int32, device=dev)
        ages[..., center] = 1
        zero = torch.zeros_like(head)
        food = place_food(prio, ages, head, zero)
        state = SnakeState(ages, head, food, torch.ones_like(head), zero, prio)
        return state, self._obs(state)

    def _obs(self, s: SnakeState):
        idx = torch.arange(self.m, device=s.ages.device)
        codes = torch.zeros_like(s.ages)
        codes.masked_fill_(idx == s.food.unsqueeze(-1), 3)
        codes.masked_fill_(s.ages > 0, 1)
        return codes.masked_fill_(idx == s.head.unsqueeze(-1), 2)

    def step(self, state: SnakeState, action, key=None):
        n, m = self.n, self.m
        idx = torch.arange(m, device=state.ages.device)
        dr, dc = move_deltas(action)
        r, c = state.head // n, state.head % n
        nr, nc = r + dr, c + dc
        inb = (nr >= 0) & (nr < n) & (nc >= 0) & (nc < n)
        cand = (nr.clamp(0, n - 1) * n + nc.clamp(0, n - 1)).to(torch.int32)
        eat = inb & (cand == state.food)
        # The tail leaves one cell unless eating (the snake grows by standing
        # still at the back); moving into the cell just left is legal.
        ages2 = (state.ages - (~eat).to(torch.int32).unsqueeze(-1)).clamp_min(0)
        at = idx == cand.unsqueeze(-1)
        hit_body = ages2.gather(-1, cand.long().unsqueeze(-1))[..., 0] > 0
        die = ~inb | hit_body
        new_len = state.length + eat.to(torch.int32)
        ages3 = torch.where(at, new_len.unsqueeze(-1), ages2)
        done = die | (new_len >= m)
        eaten = state.eaten + eat.to(torch.int32)
        placed = place_food(state.prio, ages3, cand, eaten)
        food = torch.where(eat & ~done, placed, state.food)
        reward = (eat.to(torch.float32) * EAT_REWARD
                  + die.to(torch.float32) * DEATH_REWARD)
        ns = SnakeState(ages3, cand, food, new_len, eaten, state.prio)
        return Timestep(ns, self._obs(ns), reward, done, {})

    # -- rendering (capsule scene; see kernels/raster) -----------------------
    def scene(self, state: SnakeState):
        return grid_scene(self._obs(state), self.n, self.n, INTENS)
