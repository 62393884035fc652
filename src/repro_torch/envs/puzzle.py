"""The puzzle runtime: LightsOut, batch-native (port of
`repro.envs.puzzle`; same operation order, constants copied).

LightsOut on an N×N board: pressing a cell toggles it and its von Neumann
neighbours, and the episode ends when every light is off. `reset` scrambles
a solved board with random presses, so every board is solvable, and
`solve()` is the heuristic solver the paper ships with its puzzles: a
host-side GF(2) elimination that returns an optimal press set. The CUDA
body in csrc/megastep.cu repeats `step` and `reset`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.core.env import Env, Timestep
from repro_torch.core.spaces import Box, Discrete
from repro_torch.numerics import div


class LightsOutState(NamedTuple):
    board: torch.Tensor   # (..., N, N) int32 in {0, 1}
    t: torch.Tensor       # (...,) int32


def _toggle(board: torch.Tensor, action: torch.Tensor, n: int) -> torch.Tensor:
    """Press cell `action` (per lane, int or float) on (..., N, N) boards."""
    a = action.to(torch.int64)
    r, c = (a // n)[..., None, None], (a % n)[..., None, None]
    rr = torch.arange(n, device=board.device)[:, None]
    cc = torch.arange(n, device=board.device)[None, :]
    cross = (((rr == r) & ((cc - c).abs() <= 1))
             | ((cc == c) & ((rr - r).abs() <= 1)))
    return board ^ cross.to(board.dtype)


class LightsOut(Env):
    def __init__(self, n: int = 5, scramble_presses: int = 6):
        self.n = n
        self.scramble_presses = scramble_presses
        self.observation_space = Box(low=0.0, high=1.0, shape=(n * n,))
        self.action_space = Discrete(n * n)
        self.frame_shape = (84, 84)

    def reset(self, keys):
        # Scramble from solved by random presses, so always solvable.
        presses = R.randint(keys, (self.scramble_presses,), 0, self.n * self.n)
        board = torch.zeros(keys.shape[:-1] + (self.n, self.n),
                            dtype=torch.int32, device=keys.device)
        for i in range(self.scramble_presses):
            board = _toggle(board, presses[..., i], self.n)
        state = LightsOutState(board, torch.zeros(keys.shape[:-1],
                                                  dtype=torch.int32,
                                                  device=keys.device))
        return state, self._obs(state)

    def _obs(self, s: LightsOutState):
        return s.board.flatten(-2).to(torch.float32)

    def step(self, state: LightsOutState, action, key=None):
        board = _toggle(state.board, action, self.n)
        done = board.sum((-2, -1)) == 0
        reward = torch.full(done.shape, -1.0, dtype=torch.float32,
                            device=done.device).masked_fill_(done, 10.0)
        ns = LightsOutState(board, state.t + 1)
        return Timestep(ns, self._obs(ns), reward, done, {})

    # -- rendering (capsule scene; see kernels/raster) -----------------------
    def scene(self, state: LightsOutState):
        """(..., N*N, 5) capsules and (..., N*N) intensities: a dot per cell,
        bright where the light is on. The JAX env builds the same scene
        inside its `render`."""
        n, dev, f = self.n, state.board.device, torch.float32
        centers = div(torch.arange(n, dtype=f, device=dev) + 0.5, n)
        cx = centers.repeat(n)                   # jnp.tile
        cy = centers.repeat_interleave(n)        # jnp.repeat
        r = torch.full((n * n,), 0.35 / n, dtype=f, device=dev)
        segs = torch.stack([cx, cy, cx, cy, r], -1)
        intens = self._obs(state) * 0.8 + 0.15
        return segs.expand(intens.shape + (5,)), intens

    # -- heuristic solver (host-side; paper §IV-D) ---------------------------
    def solve(self, board: np.ndarray) -> list:
        """GF(2) linear solve: returns cell indices to press (optimal set)."""
        n = self.n
        m = n * n
        a = np.zeros((m, m), np.uint8)
        for act in range(m):
            r, c = divmod(act, n)
            for dr, dc in ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)):
                rr, cc = r + dr, c + dc
                if 0 <= rr < n and 0 <= cc < n:
                    a[rr * n + cc, act] = 1
        b = np.asarray(board, np.uint8).reshape(-1).copy()
        # Gaussian elimination over GF(2).
        aug = np.concatenate([a, b[:, None]], axis=1)
        row = 0
        pivots = []
        for col in range(m):
            pivot = next((r for r in range(row, m) if aug[r, col]), None)
            if pivot is None:
                continue
            aug[[row, pivot]] = aug[[pivot, row]]
            for r in range(m):
                if r != row and aug[r, col]:
                    aug[r] ^= aug[row]
            pivots.append(col)
            row += 1
        if any(aug[r, -1] for r in range(row, m)):
            raise ValueError("unsolvable board")
        x = np.zeros(m, np.uint8)
        for r, col in enumerate(pivots):
            x[col] = aug[r, -1]
        return [i for i in range(m) if x[i]]


__all__ = ["LightsOut", "LightsOutState"]
