"""Maze: a random wall field with a goal drawn anew every episode,
batch-native (port of `repro.envs.grid.maze`; same operation order,
constants copied).

Each `reset` draws a wall layout and a goal cell from the far half of the
board, then carves a random monotone path from the start to the goal, so
every level is solvable. A move into a wall or off the board leaves the
agent in place. Reaching the goal ends the episode with +1; every other
step pays 0. The observation is the cell-code grid, `MultiDiscrete`: 0
free, 1 wall, 2 goal, 3 agent. The CUDA body in csrc/megastep.cu repeats
`step` and `reset`.
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

WALL_P = 0.35          # per-cell wall probability (off the carved path)
GOAL_REWARD = 1.0
INTENS = (0.12, 0.55, 0.85, 1.0)   # free, wall, goal, agent


class MazeState(NamedTuple):
    pos: torch.Tensor     # (...,) int32 cell index
    goal: torch.Tensor    # (...,) int32 cell index, drawn per episode
    walls: torch.Tensor   # (..., n*n) int32 in {0, 1}


class Maze(Env):
    def __init__(self, n: int = 8):
        self.n = n
        self.m = n * n
        self.observation_space = MultiDiscrete((4,) * self.m)
        self.action_space = Discrete(4)
        self.frame_shape = (84, 84)
        self.reward_range = (0.0, GOAL_REWARD)

    def reset(self, keys):
        ks = R.split(keys, 3)
        u = R.uniform(ks[..., 0, :], (self.m,))
        goal = R.randint(ks[..., 1, :], (), self.m // 2, self.m)
        path = carve_path(ks[..., 2, :], self.n, self.n, goal // self.n,
                          goal % self.n)
        walls = ((u < f32(WALL_P)) & (path == 0)).to(torch.int32)
        state = MazeState(torch.zeros_like(goal), goal, walls)
        return state, self._obs(state)

    def _obs(self, s: MazeState):
        return cell_codes(s.pos, s.goal, s.walls)

    def step(self, state: MazeState, action, key=None):
        n = self.n
        dr, dc = move_deltas(action)
        r, c = state.pos // n, state.pos % n
        cand = ((r + dr).clamp(0, n - 1) * n
                + (c + dc).clamp(0, n - 1)).to(torch.int32)
        blocked = state.walls.gather(-1, cand.long().unsqueeze(-1))[..., 0] > 0
        npos = torch.where(blocked, state.pos, cand)
        done = npos == state.goal
        reward = done.to(torch.float32) * GOAL_REWARD
        ns = MazeState(npos, state.goal, state.walls)
        return Timestep(ns, self._obs(ns), reward, done, {})

    # -- rendering (capsule scene; see kernels/raster) -----------------------
    def scene(self, state: MazeState):
        return grid_scene(self._obs(state), self.n, self.n, INTENS)
