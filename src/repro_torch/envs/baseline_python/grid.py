"""Pure-Python gridworld baselines — the interpreted comparator twins.

Same per-episode procedural generation (python RNG instead of threefry, so
distributions match but not bit-streams) and the *same dynamics given the
same state*: `set_state` copies a compiled env's state pytree so the
conformance sweep (tests/test_conformance.py) can assert step-for-step
trajectory equality between the interpreted and compiled execution models.

SnakePy computes the food chain in float32 numpy on purpose: the compiled
env places food by minimising frac(prio + k·φ) in f32 (envs/grid/snake.py),
and doing the same math in python f64 could round a near-tie the other way.
"""
from __future__ import annotations

import numpy as np

from repro_torch.envs.baseline_python.classic import _BaselineEnv
from repro_torch.envs.grid.cliff_walk import CLIFF_P, CLIFF_REWARD, STEP_REWARD
from repro_torch.envs.grid.cliff_walk import INTENS as CLIFF_INTENS
from repro_torch.envs.grid.frozen_lake import GOAL_REWARD, HOLE_P
from repro_torch.envs.grid.frozen_lake import INTENS as LAKE_INTENS
from repro_torch.envs.grid.maze import INTENS as MAZE_INTENS
from repro_torch.envs.grid.maze import WALL_P
from repro_torch.envs.grid.snake import DEATH_REWARD, EAT_REWARD, PHI
from repro_torch.envs.grid.snake import INTENS as SNAKE_INTENS

# Gym FrozenLake action order (envs/grid/common.move_deltas): (dr, dc).
_MOVES = {0: (0, -1), 1: (1, 0), 2: (0, 1), 3: (-1, 0)}


def _carve(rng, n_cols, goal_r, goal_c):
    """Python twin of common.carve_path: random monotone path (0,0)->goal."""
    r = c = 0
    cells = {0}
    while r != goal_r or c != goal_c:
        need_r, need_c = goal_r - r, goal_c - c
        if need_r != 0 and (need_c == 0 or rng.random() < 0.5):
            r += 1 if need_r > 0 else -1
        else:
            c += 1 if need_c > 0 else -1
        cells.add(r * n_cols + c)
    return cells


class _GridPy(_BaselineEnv):
    n_actions = 4
    n_rows: int
    n_cols: int
    intens: tuple

    def _codes(self):
        raise NotImplementedError

    def scene(self):
        codes = self._codes()
        segs, intens = [], []
        rad = 0.35 / max(self.n_rows, self.n_cols)
        for i, code in enumerate(codes):
            cx = (i % self.n_cols + 0.5) / self.n_cols
            cy = (i // self.n_cols + 0.5) / self.n_rows
            segs.append([cx, cy, cx, cy, rad])
            intens.append(self.intens[code])
        return segs, intens

    def _move(self, pos, action):
        r, c = divmod(pos, self.n_cols)
        dr, dc = _MOVES[int(action)]
        nr = max(min(r + dr, self.n_rows - 1), 0)
        nc = max(min(c + dc, self.n_cols - 1), 0)
        return nr * self.n_cols + nc


class FrozenLakePy(_GridPy):
    n_rows = n_cols = 4
    intens = LAKE_INTENS
    max_steps = 100

    def reset(self):
        m = self.n_rows * self.n_cols
        path = _carve(self._rng, self.n_cols, self.n_rows - 1, self.n_cols - 1)
        self.holes = [0 if i in path else int(self._rng.random() < HOLE_P)
                      for i in range(m)]
        self.pos = 0
        self.steps = 0
        return self._codes()

    def set_state(self, state):
        self.pos = int(state.pos)
        self.holes = [int(h) for h in np.asarray(state.holes)]
        self.steps = 0

    def _codes(self):
        m = self.n_rows * self.n_cols
        return [3 if i == self.pos else (2 if i == m - 1 else self.holes[i])
                for i in range(m)]

    def step(self, action):
        m = self.n_rows * self.n_cols
        self.pos = self._move(self.pos, action)
        goal = self.pos == m - 1
        terminal = goal or self.holes[self.pos] > 0
        self.steps += 1
        truncated = not terminal and self.steps >= self.max_steps
        reward = GOAL_REWARD if goal else 0.0
        return self._codes(), reward, terminal or truncated, \
            {"truncated": truncated}


class CliffWalkPy(_GridPy):
    n_rows, n_cols = 4, 12
    intens = CLIFF_INTENS
    max_steps = 100

    def reset(self):
        m = self.n_rows * self.n_cols
        safe_row = self._rng.randrange(self.n_rows - 1)
        self.cliff = []
        for i in range(m):
            r, c = divmod(i, self.n_cols)
            safe = c == 0 or c == self.n_cols - 1 or r == safe_row
            bottom = r == self.n_rows - 1 and 0 < c < self.n_cols - 1
            self.cliff.append(
                0 if safe else int(bottom or self._rng.random() < CLIFF_P))
        self.pos = (self.n_rows - 1) * self.n_cols
        self.steps = 0
        return self._codes()

    def set_state(self, state):
        self.pos = int(state.pos)
        self.cliff = [int(x) for x in np.asarray(state.cliff)]
        self.steps = 0

    def _codes(self):
        m = self.n_rows * self.n_cols
        return [3 if i == self.pos else (2 if i == m - 1 else self.cliff[i])
                for i in range(m)]

    def step(self, action):
        m = self.n_rows * self.n_cols
        npos = self._move(self.pos, action)
        fell = self.cliff[npos] > 0
        goal = npos == m - 1
        self.pos = (self.n_rows - 1) * self.n_cols if fell else npos
        self.steps += 1
        truncated = not goal and self.steps >= self.max_steps
        reward = CLIFF_REWARD if fell else STEP_REWARD
        return self._codes(), reward, goal or truncated, \
            {"truncated": truncated}


class MazePy(_GridPy):
    n_rows = n_cols = 8
    intens = MAZE_INTENS
    max_steps = 200

    def reset(self):
        m = self.n_rows * self.n_cols
        self.goal = self._rng.randrange(m // 2, m)
        path = _carve(self._rng, self.n_cols, self.goal // self.n_cols,
                      self.goal % self.n_cols)
        self.walls = [0 if i in path else int(self._rng.random() < WALL_P)
                      for i in range(m)]
        self.pos = 0
        self.steps = 0
        return self._codes()

    def set_state(self, state):
        self.pos = int(state.pos)
        self.goal = int(state.goal)
        self.walls = [int(w) for w in np.asarray(state.walls)]
        self.steps = 0

    def _codes(self):
        m = self.n_rows * self.n_cols
        return [3 if i == self.pos else (2 if i == self.goal else self.walls[i])
                for i in range(m)]

    def step(self, action):
        cand = self._move(self.pos, action)
        if not self.walls[cand]:
            self.pos = cand
        done = self.pos == self.goal
        self.steps += 1
        truncated = not done and self.steps >= self.max_steps
        reward = 1.0 if done else 0.0
        return self._codes(), reward, done or truncated, \
            {"truncated": truncated}


class SnakePy(_GridPy):
    n_rows = n_cols = 6
    intens = SNAKE_INTENS
    max_steps = 200

    def _place_food(self, k):
        # f32 twin of envs/grid/snake.place_food — see module docstring.
        m = self.n_rows * self.n_cols
        vals = self.prio + np.float32(k) * np.float32(PHI)
        vals = vals - np.floor(vals)
        free = (self.ages == 0) & (np.arange(m) != self.head)
        v = np.where(free, vals, np.float32(2.0))
        vmin = v.min()
        return int(np.min(np.where(v == vmin, np.arange(m), m)))

    def reset(self):
        m = self.n_rows * self.n_cols
        self.prio = np.asarray([self._rng.random() for _ in range(m)],
                               np.float32)
        self.head = (self.n_rows // 2) * self.n_cols + self.n_cols // 2
        self.ages = np.zeros((m,), np.int64)
        self.ages[self.head] = 1
        self.length = 1
        self.eaten = 0
        self.food = self._place_food(0)
        self.steps = 0
        return self._codes()

    def set_state(self, state):
        self.prio = np.asarray(state.prio, np.float32)
        self.head = int(state.head)
        self.ages = np.asarray(state.ages, np.int64).copy()
        self.length = int(state.length)
        self.eaten = int(state.eaten)
        self.food = int(state.food)
        self.steps = 0

    def _codes(self):
        m = self.n_rows * self.n_cols
        return [2 if i == self.head else
                (1 if self.ages[i] > 0 else (3 if i == self.food else 0))
                for i in range(m)]

    def step(self, action):
        m = self.n_rows * self.n_cols
        r, c = divmod(self.head, self.n_cols)
        dr, dc = _MOVES[int(action)]
        nr, nc = r + dr, c + dc
        inb = 0 <= nr < self.n_rows and 0 <= nc < self.n_cols
        cand = (max(min(nr, self.n_rows - 1), 0) * self.n_cols
                + max(min(nc, self.n_cols - 1), 0))
        eat = inb and cand == self.food
        if not eat:
            self.ages = np.maximum(self.ages - 1, 0)
        die = not inb or self.ages[cand] > 0
        self.length += int(eat)
        self.ages[cand] = self.length
        self.head = cand
        win = self.length >= m
        done = die or win
        if eat:
            self.eaten += 1
            if not done:
                self.food = self._place_food(self.eaten)
        self.steps += 1
        truncated = not done and self.steps >= self.max_steps
        reward = EAT_REWARD * eat + DEATH_REWARD * die
        return self._codes(), reward, done or truncated, \
            {"truncated": truncated}
