"""FrozenLake, with the map drawn anew every episode, batch-native (port of
`repro.envs.grid.frozen_lake`; same operation order, constants copied).

Gym's FrozenLake without slip: each `reset` draws a hole field (density
`HOLE_P`) and carves a random monotone path from the start to the goal, so
every level is solvable. The observation is the whole cell-code grid as a
`MultiDiscrete` vector: 0 frozen, 1 hole, 2 goal, 3 agent. The CUDA body in
csrc/megastep.cu repeats `step` and `reset`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random as R
from repro_torch.core.env import Env, Timestep
from repro_torch.core.spaces import Discrete, MultiDiscrete
from repro_torch.envs.grid.common import (carve_path, cell_codes, grid_scene,
                                          move_deltas)
from repro_torch.numerics import f32

HOLE_P = 0.3          # per-cell hole probability (off the carved path)
GOAL_REWARD = 1.0
INTENS = (0.25, 0.0, 0.8, 1.0)   # frozen, hole (dark), goal, agent


class FrozenLakeState(NamedTuple):
    pos: torch.Tensor     # (...,) int32 cell index
    holes: torch.Tensor   # (..., n*n) int32 in {0, 1}: this episode's level


class FrozenLake(Env):
    def __init__(self, n: int = 4):
        self.n = n
        self.m = n * n
        self.observation_space = MultiDiscrete((4,) * self.m)
        self.action_space = Discrete(4)
        self.frame_shape = (84, 84)
        self.reward_range = (0.0, GOAL_REWARD)

    def reset(self, keys):
        pair = R.split(keys)
        u = R.uniform(pair[..., 0, :], (self.m,))
        path = carve_path(pair[..., 1, :], self.n, self.n, self.n - 1,
                          self.n - 1)
        holes = ((u < f32(HOLE_P)) & (path == 0)).to(torch.int32)
        state = FrozenLakeState(
            torch.zeros(keys.shape[:-1], dtype=torch.int32,
                        device=keys.device), holes)
        return state, self._obs(state)

    def _obs(self, s: FrozenLakeState):
        return cell_codes(s.pos, self.m - 1, s.holes)

    def step(self, state: FrozenLakeState, action, key=None):
        n = self.n
        dr, dc = move_deltas(action)
        r, c = state.pos // n, state.pos % n
        npos = ((r + dr).clamp(0, n - 1) * n
                + (c + dc).clamp(0, n - 1)).to(torch.int32)
        hole = state.holes.gather(-1, npos.long().unsqueeze(-1))[..., 0] > 0
        goal = npos == self.m - 1
        reward = goal.to(torch.float32) * GOAL_REWARD
        ns = FrozenLakeState(npos, state.holes)
        return Timestep(ns, self._obs(ns), reward, hole | goal, {})

    # -- rendering (capsule scene; see kernels/raster) -----------------------
    def scene(self, state: FrozenLakeState):
        return grid_scene(self._obs(state), self.n, self.n, INTENS)
