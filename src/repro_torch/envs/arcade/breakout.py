"""Breakout, batch-native (port of `repro.envs.arcade.breakout`; same
operation order, constants copied).

The agent drives a paddle (Discrete(3): left/stay/right) returning a ball
into a 4×6 brick grid; each broken brick pays +1, clearing the board pays a
+5 bonus and ends the episode, dropping the ball past the paddle ends it
with no reward. Coordinates are the rasteriser's [0, 1]², x rightward, y
downward. The observation is the state vector (ball, paddle, brick board);
the registered `Breakout-v0` id observes 4 stacked 84×84 renders of
`scene()` instead. The CUDA body in csrc/megastep.cu repeats `step` and
`reset`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random as R
from repro_torch.core.env import Env, Timestep
from repro_torch.core.spaces import Box, Discrete
from repro_torch.numerics import div

BRICK_ROWS = 4
BRICK_COLS = 6
BRICK_TOP = 0.12       # top of the brick region
BRICK_H = 0.05         # brick row height
PADDLE_Y = 0.92        # paddle plane
PADDLE_HALF = 0.14     # paddle half-width
PADDLE_SPEED = 0.06    # paddle speed per step
BALL_VX0 = 0.022       # serve horizontal speed
BALL_VY0 = 0.03        # serve vertical speed (downward)
SPIN = 0.15            # horizontal deflection per unit of paddle offset
MAX_VX = 0.04          # horizontal ball speed cap
CLEAR_BONUS = 5.0      # board-clear bonus reward


class BreakoutState(NamedTuple):
    ball_x: torch.Tensor
    ball_y: torch.Tensor
    ball_vx: torch.Tensor
    ball_vy: torch.Tensor
    paddle_x: torch.Tensor
    bricks: torch.Tensor   # (..., BRICK_ROWS, BRICK_COLS) int32 in {0, 1}


class Breakout(Env):
    observation_space = Box(low=-1.0, high=1.0,
                            shape=(5 + BRICK_ROWS * BRICK_COLS,))
    action_space = Discrete(3)
    frame_shape = (84, 84)

    def reset(self, keys):
        pair = R.split(keys)
        ball_x = R.uniform(pair[..., 0, :], (), 0.2, 0.8)
        serve = torch.full_like(ball_x, -1.0).masked_fill_(
            R.bernoulli(pair[..., 1, :]), 1.0)
        state = BreakoutState(
            ball_x, torch.full_like(ball_x, 0.55), BALL_VX0 * serve,
            torch.full_like(ball_x, BALL_VY0), torch.full_like(ball_x, 0.5),
            torch.ones(ball_x.shape + (BRICK_ROWS, BRICK_COLS),
                       dtype=torch.int32, device=ball_x.device))
        return state, self._obs(state)

    @staticmethod
    def _obs(s: BreakoutState):
        # obs == flattened state, in flatten-row order (fused-spec contract)
        return torch.cat([
            torch.stack([s.ball_x, s.ball_y, s.ball_vx, s.ball_vy, s.paddle_x],
                        -1),
            s.bricks.reshape(s.bricks.shape[:-2] + (-1,)).to(torch.float32),
        ], -1)

    def step(self, state: BreakoutState, action, key=None):
        move = (action - 1).to(torch.float32)  # {-1, 0, +1}
        paddle_x = (state.paddle_x + move * PADDLE_SPEED).clamp(
            PADDLE_HALF, 1.0 - PADDLE_HALF)

        nx = state.ball_x + state.ball_vx
        ny = state.ball_y + state.ball_vy
        vx, vy = state.ball_vx, state.ball_vy
        # side walls
        vx = torch.where((nx < 0.0) | (nx > 1.0), -vx, vx)
        nx = torch.where(nx < 0.0, -nx, nx)
        nx = torch.where(nx > 1.0, 2.0 - nx, nx)
        # ceiling
        vy = torch.where(ny < 0.0, -vy, vy)
        ny = torch.where(ny < 0.0, -ny, ny)
        # paddle bounce (crossing the paddle plane within reach)
        hit_pad = ((state.ball_y < PADDLE_Y) & (ny >= PADDLE_Y)
                   & ((nx - paddle_x).abs() <= PADDLE_HALF))
        vx = torch.where(hit_pad, (vx + (nx - paddle_x) * SPIN).clamp(
            -MAX_VX, MAX_VX), vx)
        vy = torch.where(hit_pad, -vy, vy)
        ny = torch.where(hit_pad, 2.0 * PADDLE_Y - ny, ny)
        # brick collision: the cell under the ball, by (row, col) comparisons
        # over the board, as the JAX env's iota planes do
        board = state.bricks.to(torch.float32)
        rr = torch.arange(BRICK_ROWS, dtype=torch.float32,
                          device=board.device)[:, None]
        cc = torch.arange(BRICK_COLS, dtype=torch.float32,
                          device=board.device)[None, :]
        cell_r = torch.floor(div(ny - BRICK_TOP, BRICK_H))[..., None, None]
        cell_c = torch.floor(nx * BRICK_COLS)[..., None, None]
        in_region = ((ny >= BRICK_TOP)
                     & (ny < BRICK_TOP + BRICK_ROWS * BRICK_H))
        mask = (((rr == cell_r) & (cc == cell_c)).to(torch.float32)
                * in_region.to(torch.float32)[..., None, None] * board)
        broke = mask.sum((-2, -1))    # 0.0 or 1.0: at most one cell matches
        new_board = board - mask
        vy = torch.where(broke > 0.0, -vy, vy)

        cleared = new_board.sum((-2, -1)) == 0.0
        lost = ny > 1.0
        reward = broke + torch.zeros_like(broke).masked_fill_(cleared,
                                                              CLEAR_BONUS)
        ns = BreakoutState(nx, ny, vx, vy, paddle_x,
                           new_board.to(torch.int32))
        return Timestep(ns, self._obs(ns), reward, cleared | lost, {})

    # -- rendering (capsule scene; see kernels/raster) -----------------------
    def scene(self, state: BreakoutState):
        """(..., 26, 5) capsules and (..., 26) intensities: the 24 bricks
        (intensity 0 once broken), the paddle and the ball. Constants are
        built on the state's device from fills and aranges."""
        from repro_torch.kernels.raster import capsule_scene

        r, c = BRICK_ROWS, BRICK_COLS
        dev, lead = state.ball_x.device, state.ball_x.shape
        f32 = torch.float32
        bx = div(torch.arange(c, dtype=f32, device=dev) + 0.5, c)
        by = BRICK_TOP + (torch.arange(r, dtype=f32, device=dev) + 0.5) * BRICK_H
        bx = bx[None, :].expand(r, c).reshape(-1)      # jnp.tile
        by = by[:, None].expand(r, c).reshape(-1)      # jnp.repeat
        bricks = torch.stack([bx - 0.35 / c, by, bx + 0.35 / c, by,
                              torch.full_like(bx, 0.016)], -1)
        dyn, dyn_int = capsule_scene(state.ball_x, [
            (state.paddle_x - PADDLE_HALF, PADDLE_Y,
             state.paddle_x + PADDLE_HALF, PADDLE_Y, 0.018),          # paddle
            (state.ball_x, state.ball_y, state.ball_x, state.ball_y,
             0.02),                                                   # ball
        ], (1.0, 0.9))
        segs = torch.cat([bricks.expand(lead + (r * c, 5)), dyn], -2)
        intens = torch.cat([
            state.bricks.reshape(lead + (r * c,)).to(f32) * 0.7, dyn_int], -1)
        return segs, intens
