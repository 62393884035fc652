"""CliffWalk: Sutton and Barto's cliff, extended anew every episode,
batch-native (port of `repro.envs.grid.cliff_walk`; same operation order,
constants copied).

The classic 4×12 cliff (the bottom row between start and goal) plus random
extra cliff cells drawn at each reset. A random safe row, column 0 and the
last column stay clear, so the up-across-down route always exists. A step
into the cliff sends the agent back to the start with reward -100 and the
episode goes on; every other step pays -1, and only the goal ends it. The
observation is the cell-code grid, `MultiDiscrete`: 0 free, 1 cliff, 2
goal, 3 agent. The CUDA body in csrc/megastep.cu repeats `step` and
`reset`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random as R
from repro_torch.core.env import Env, Timestep
from repro_torch.core.spaces import Discrete, MultiDiscrete
from repro_torch.envs.grid.common import cell_codes, grid_scene, move_deltas
from repro_torch.numerics import f32

CLIFF_P = 0.25         # interior extra-cliff probability (off the safe rails)
CLIFF_REWARD = -100.0
STEP_REWARD = -1.0
INTENS = (0.25, 0.0, 0.8, 1.0)   # free, cliff (dark), goal, agent


class CliffWalkState(NamedTuple):
    pos: torch.Tensor     # (...,) int32 cell index
    cliff: torch.Tensor   # (..., n_rows*n_cols) int32 in {0, 1}


class CliffWalk(Env):
    def __init__(self, n_rows: int = 4, n_cols: int = 12):
        self.n_rows = n_rows
        self.n_cols = n_cols
        self.m = n_rows * n_cols
        self.start = (n_rows - 1) * n_cols      # bottom-left
        self.observation_space = MultiDiscrete((4,) * self.m)
        self.action_space = Discrete(4)
        self.frame_shape = (84, 84)
        self.reward_range = (CLIFF_REWARD, STEP_REWARD)

    def reset(self, keys):
        pair = R.split(keys)
        u = R.uniform(pair[..., 0, :], (self.m,))
        safe_row = R.randint(pair[..., 1, :], (), 0, self.n_rows - 1)
        idx = torch.arange(self.m, device=keys.device)
        r, c = idx // self.n_cols, idx % self.n_cols
        safe = ((c == 0) | (c == self.n_cols - 1)
                | (r == safe_row.unsqueeze(-1)))
        bottom = (r == self.n_rows - 1) & (c > 0) & (c < self.n_cols - 1)
        cliff = ((bottom | (u < f32(CLIFF_P))) & ~safe).to(torch.int32)
        state = CliffWalkState(
            torch.full(keys.shape[:-1], self.start, dtype=torch.int32,
                       device=keys.device), cliff)
        return state, self._obs(state)

    def _obs(self, s: CliffWalkState):
        return cell_codes(s.pos, self.m - 1, s.cliff)

    def step(self, state: CliffWalkState, action, key=None):
        dr, dc = move_deltas(action)
        r, c = state.pos // self.n_cols, state.pos % self.n_cols
        npos = ((r + dr).clamp(0, self.n_rows - 1) * self.n_cols
                + (c + dc).clamp(0, self.n_cols - 1)).to(torch.int32)
        fell = state.cliff.gather(-1, npos.long().unsqueeze(-1))[..., 0] > 0
        goal = npos == self.m - 1
        pos = npos.masked_fill(fell, self.start)
        reward = torch.full(pos.shape, STEP_REWARD, dtype=torch.float32,
                            device=pos.device).masked_fill_(fell, CLIFF_REWARD)
        ns = CliffWalkState(pos, state.cliff)
        return Timestep(ns, self._obs(ns), reward, goal, {})

    # -- rendering (capsule scene; see kernels/raster) -----------------------
    def scene(self, state: CliffWalkState):
        return grid_scene(self._obs(state), self.n_rows, self.n_cols, INTENS)
