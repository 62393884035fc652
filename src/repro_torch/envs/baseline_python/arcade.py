"""Pure-Python arcade baselines — the interpreted comparator for Pong/Breakout.

Same dynamics constants and operation order as the compiled arcade envs
(envs/arcade), one interpreted step per call, software rendering via the
NumPy rasteriser — exactly the execution model Fig. 1 measures against.
A 1000-step time limit matches the registered `-v0` wrapping.
"""
from __future__ import annotations

import math

from repro_torch.envs.arcade.breakout import (
    BALL_VX0, BALL_VY0, BRICK_COLS, BRICK_H, BRICK_ROWS, BRICK_TOP,
    CLEAR_BONUS, MAX_VX)
from repro_torch.envs.arcade.breakout import PADDLE_HALF as BK_PADDLE_HALF
from repro_torch.envs.arcade.breakout import PADDLE_SPEED as BK_PADDLE_SPEED
from repro_torch.envs.arcade.breakout import PADDLE_Y
from repro_torch.envs.arcade.breakout import SPIN as BK_SPIN
from repro_torch.envs.arcade.pong import (
    BALL_SPEED_X, MAX_VY, OPP_SPEED, OPP_X, PADDLE_HALF, PADDLE_SPEED,
    PLAYER_X, SPIN)
from repro_torch.envs.baseline_python.classic import _BaselineEnv

MAX_STEPS = 1000


def _clip(x, lo, hi):
    return lo if x < lo else hi if x > hi else x


class PongPy(_BaselineEnv):
    n_actions = 3

    def reset(self):
        self.ball_x = 0.5
        self.ball_y = self._rng.uniform(0.3, 0.7)
        self.ball_vx = BALL_SPEED_X if self._rng.random() < 0.5 else -BALL_SPEED_X
        self.ball_vy = self._rng.uniform(-0.02, 0.02)
        self.player_y = 0.5
        self.opp_y = 0.5
        self.steps = 0
        return self._obs()

    def _obs(self):
        return [self.ball_x, self.ball_y, self.ball_vx, self.ball_vy,
                self.player_y, self.opp_y]

    def step(self, action):
        move = action - 1
        self.player_y = _clip(self.player_y + move * PADDLE_SPEED,
                              PADDLE_HALF, 1.0 - PADDLE_HALF)
        self.opp_y = _clip(self.opp_y + _clip(self.ball_y - self.opp_y,
                                              -OPP_SPEED, OPP_SPEED),
                           PADDLE_HALF, 1.0 - PADDLE_HALF)
        nx = self.ball_x + self.ball_vx
        ny = self.ball_y + self.ball_vy
        vx, vy = self.ball_vx, self.ball_vy
        if ny < 0.0 or ny > 1.0:
            vy = -vy
            ny = -ny if ny < 0.0 else 2.0 - ny
        if self.ball_x < PLAYER_X <= nx and abs(ny - self.player_y) <= PADDLE_HALF:
            vy = _clip(vy + (ny - self.player_y) * SPIN, -MAX_VY, MAX_VY)
            vx = -vx
            nx = 2.0 * PLAYER_X - nx
        if self.ball_x > OPP_X >= nx and abs(ny - self.opp_y) <= PADDLE_HALF:
            vy = _clip(vy + (ny - self.opp_y) * SPIN, -MAX_VY, MAX_VY)
            vx = -vx
            nx = 2.0 * OPP_X - nx
        self.ball_x, self.ball_y, self.ball_vx, self.ball_vy = nx, ny, vx, vy
        self.steps += 1
        reward = float(nx < 0.0) - float(nx > 1.0)
        terminal = nx < 0.0 or nx > 1.0
        truncated = not terminal and self.steps >= MAX_STEPS
        return self._obs(), reward, terminal or truncated, {"truncated": truncated}

    def scene(self):
        return [
            [0.5, 0.02, 0.5, 0.98, 0.004],
            [OPP_X, self.opp_y - PADDLE_HALF, OPP_X,
             self.opp_y + PADDLE_HALF, 0.02],
            [PLAYER_X, self.player_y - PADDLE_HALF, PLAYER_X,
             self.player_y + PADDLE_HALF, 0.02],
            [self.ball_x, self.ball_y, self.ball_x, self.ball_y, 0.022],
        ], [0.25, 0.7, 1.0, 0.9]


class BreakoutPy(_BaselineEnv):
    n_actions = 3

    def reset(self):
        self.ball_x = self._rng.uniform(0.2, 0.8)
        self.ball_y = 0.55
        self.ball_vx = BALL_VX0 if self._rng.random() < 0.5 else -BALL_VX0
        self.ball_vy = BALL_VY0
        self.paddle_x = 0.5
        self.bricks = [[1] * BRICK_COLS for _ in range(BRICK_ROWS)]
        self.steps = 0
        return self._obs()

    def _obs(self):
        flat = [float(b) for row in self.bricks for b in row]
        return [self.ball_x, self.ball_y, self.ball_vx, self.ball_vy,
                self.paddle_x] + flat

    def step(self, action):
        move = action - 1
        self.paddle_x = _clip(self.paddle_x + move * BK_PADDLE_SPEED,
                              BK_PADDLE_HALF, 1.0 - BK_PADDLE_HALF)
        nx = self.ball_x + self.ball_vx
        ny = self.ball_y + self.ball_vy
        vx, vy = self.ball_vx, self.ball_vy
        if nx < 0.0 or nx > 1.0:
            vx = -vx
            nx = -nx if nx < 0.0 else 2.0 - nx
        if ny < 0.0:
            vy = -vy
            ny = -ny
        if (self.ball_y < PADDLE_Y <= ny
                and abs(nx - self.paddle_x) <= BK_PADDLE_HALF):
            vx = _clip(vx + (nx - self.paddle_x) * BK_SPIN, -MAX_VX, MAX_VX)
            vy = -vy
            ny = 2.0 * PADDLE_Y - ny
        reward = 0.0
        if BRICK_TOP <= ny < BRICK_TOP + BRICK_ROWS * BRICK_H:
            r = int(math.floor((ny - BRICK_TOP) / BRICK_H))
            c = int(math.floor(nx * BRICK_COLS))
            if 0 <= r < BRICK_ROWS and 0 <= c < BRICK_COLS and self.bricks[r][c]:
                self.bricks[r][c] = 0
                vy = -vy
                reward = 1.0
        self.ball_x, self.ball_y, self.ball_vx, self.ball_vy = nx, ny, vx, vy
        self.steps += 1
        cleared = not any(b for row in self.bricks for b in row)
        if cleared:
            reward += CLEAR_BONUS
        terminal = cleared or ny > 1.0
        truncated = not terminal and self.steps >= MAX_STEPS
        return self._obs(), reward, terminal or truncated, {"truncated": truncated}

    def scene(self):
        segs, intens = [], []
        for r in range(BRICK_ROWS):
            for c in range(BRICK_COLS):
                bx = (c + 0.5) / BRICK_COLS
                by = BRICK_TOP + (r + 0.5) * BRICK_H
                segs.append([bx - 0.35 / BRICK_COLS, by,
                             bx + 0.35 / BRICK_COLS, by, 0.016])
                intens.append(self.bricks[r][c] * 0.7)
        segs.append([self.paddle_x - BK_PADDLE_HALF, PADDLE_Y,
                     self.paddle_x + BK_PADDLE_HALF, PADDLE_Y, 0.018])
        intens.append(1.0)
        segs.append([self.ball_x, self.ball_y, self.ball_x, self.ball_y, 0.02])
        intens.append(0.9)
        return segs, intens
