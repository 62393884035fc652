"""Shared helpers of the procedural gridworld suite, batch-native (port of
`repro.envs.grid.common`).

Every grid game draws its level (holes, cliff or walls, goal, food
priorities) inside `reset`, from the lane's key, so the AutoReset key chain
makes a new level at every episode boundary on the device, and the fused
path makes the same levels: the CUDA megastep draws them in-kernel from the
same key chain (csrc/megastep.cu repeats `reset` and `carve_path`), its
plain twin precomputes them with these calls. Levels are solvable by
construction: `carve_path` marks a random monotone lattice path from the
start to the goal, and no obstacle is placed on it.
"""
from __future__ import annotations

import torch

from repro_torch import random as R
from repro_torch.numerics import div, f32


def carve_path(keys: torch.Tensor, n_rows: int, n_cols: int, goal_r,
               goal_c) -> torch.Tensor:
    """Random monotone lattice path (0, 0) -> (goal_r, goal_c), per lane.

    keys (..., 2); goal_r and goal_c are ints or int tensors of the keys'
    leading shape (Maze draws its goal per lane). Returns a (..., n_rows *
    n_cols) int32 mask with 1 on every path cell, start and goal included.
    Each of the n_rows + n_cols - 2 steps moves one row or one column toward
    the goal, the axis drawn at random while both are needed, and stands
    still once the goal is reached, as the JAX loop does.
    """
    lead, dev = keys.shape[:-1], keys.device
    steps = n_rows + n_cols - 2
    u = R.uniform(keys, (steps,))
    # a fill for an int goal: no host-to-device copy on the step path
    lane = lambda g: (g.to(torch.int32) if isinstance(g, torch.Tensor) else
                      torch.full(lead, int(g), dtype=torch.int32, device=dev))
    goal_r, goal_c = lane(goal_r), lane(goal_c)
    r = torch.zeros(lead, dtype=torch.int32, device=dev)
    c = torch.zeros_like(r)
    mask = torch.zeros(lead + (n_rows * n_cols,), dtype=torch.int32, device=dev)
    mask[..., 0] = 1
    for i in range(steps):
        need_r, need_c = goal_r - r, goal_c - c
        go_row = (need_r != 0) & ((need_c == 0) | (u[..., i] < 0.5))
        go_col = ~go_row & (need_c != 0)
        r = r + torch.where(go_row, torch.sign(need_r), 0)
        c = c + torch.where(go_col, torch.sign(need_c), 0)
        mask.scatter_(-1, (r * n_cols + c).long().unsqueeze(-1), 1)
    return mask


def move_deltas(action: torch.Tensor):
    """Gym FrozenLake action order: 0 left, 1 down, 2 right, 3 up. Returns
    int32 (dr, dc); float actions (the fused rows) work alike."""
    one = lambda v: (action == v).to(torch.int32)
    return one(1) - one(3), one(2) - one(0)


def cell_codes(pos, goal, plane) -> torch.Tensor:
    """The cell-code grid (..., m) int32 of FrozenLake, CliffWalk and Maze:
    3 at the agent's cell, else 2 at the goal (an int, or a cell index per
    lane), else the 0/1 `plane` (holes, cliff or walls)."""
    idx = torch.arange(plane.shape[-1], device=plane.device)
    codes = plane.to(torch.int32, copy=True)
    if isinstance(goal, int):
        codes[..., goal] = 2
    else:
        codes.masked_fill_(idx == goal.unsqueeze(-1), 2)
    return codes.masked_fill_(idx == pos.unsqueeze(-1), 3)


def grid_scene(codes: torch.Tensor, n_rows: int, n_cols: int, intens_table):
    """Per-cell capsule scene (kernels/raster contract): a point capsule at
    each cell centre, its intensity looked up from the cell's code. Returns
    (..., m, 5) and (..., m) float32; the constants are built on the codes'
    device from aranges and fills, with no host copy."""
    m, dev, f = n_rows * n_cols, codes.device, torch.float32
    idx = torch.arange(m, device=dev)
    cx = div((idx % n_cols).to(f) + 0.5, n_cols)
    cy = div((idx // n_cols).to(f) + 0.5, n_rows)
    rad = torch.full((m,), 0.35 / max(n_rows, n_cols), dtype=f, device=dev)
    segs = torch.stack([cx, cy, cx, cy, rad], -1)
    intens = torch.full(codes.shape, f32(intens_table[-1]), dtype=f,
                        device=dev)
    for code in range(len(intens_table) - 1):
        intens.masked_fill_(codes == code, f32(intens_table[code]))
    return segs.expand(codes.shape + (5,)), intens


__all__ = ["carve_path", "cell_codes", "grid_scene", "move_deltas"]
