"""Multitask, the paper's flagship Flash game, batch-native (port of
`repro.envs.multitask`; same operation order, constants copied).

Two minigames share one Discrete(3) action (left, stay, right): CATCH, a
ball falls and the paddle must be under it when it lands; DODGE, an
obstacle falls down one of three lanes and the player must not be in that
lane when it lands. Failing either ends the episode (-10); every other step
pays +1. The observation is the 10-float game state ("virtual Flash
memory"). It is the one env whose `step` draws random numbers, the new
ball and obstacle, from the per-step lane keys, so it has no megastep body
and runs the vmap backend.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random as R
from repro_torch.core.env import Env, Timestep
from repro_torch.core.spaces import Box, Discrete
from repro_torch.numerics import div

BALL_SPEED = 0.05
OBSTACLE_SPEED = 0.04
PADDLE_SPEED = 0.07
CATCH_RADIUS = 0.13
ALIVE_REWARD = 1.0
FAIL_REWARD = -10.0


class MultitaskState(NamedTuple):
    paddle_x: torch.Tensor     # [0, 1]
    ball_x: torch.Tensor       # [0, 1]
    ball_y: torch.Tensor       # [0, 1], 1 = bottom
    lane: torch.Tensor         # player lane {0, 1, 2}, int32
    obs_lane: torch.Tensor     # obstacle lane {0, 1, 2}, int32
    obs_y: torch.Tensor        # [0, 1]
    t: torch.Tensor            # int32


class Multitask(Env):
    observation_space = Box(low=0.0, high=1.0, shape=(10,))
    action_space = Discrete(3)
    frame_shape = (84, 84)

    def reset(self, keys):
        pair = R.split(keys)
        ball_x = R.uniform(pair[..., 0, :], (), 0.1, 0.9)
        zeros = torch.zeros_like(ball_x)
        lane = torch.ones(ball_x.shape, dtype=torch.int32, device=keys.device)
        state = MultitaskState(
            paddle_x=torch.full_like(ball_x, 0.5), ball_x=ball_x,
            ball_y=zeros, lane=lane,
            obs_lane=R.randint(pair[..., 1, :], (), 0, 3), obs_y=zeros,
            t=torch.zeros_like(lane))
        return state, self._obs(state)

    @staticmethod
    def _obs(s: MultitaskState):
        lanes = torch.arange(3, device=s.lane.device)
        return torch.cat([
            torch.stack([s.paddle_x, s.ball_x, s.ball_y, s.obs_y], -1),
            (s.lane.unsqueeze(-1) == lanes).to(torch.float32),
            (s.obs_lane.unsqueeze(-1) == lanes).to(torch.float32)], -1)

    def step(self, state: MultitaskState, action, key=None):
        if key is None:
            raise ValueError("Multitask.step draws the new ball and obstacle "
                             "from the per-step lane keys; pass key")
        pair = R.split(key)
        move_i = action.to(torch.int32) - 1            # {-1, 0, +1}
        move = move_i.to(torch.float32)

        # CATCH minigame.
        paddle_x = (state.paddle_x + move * PADDLE_SPEED).clamp(0.05, 0.95)
        ball_y = state.ball_y + BALL_SPEED
        landing = ball_y >= 1.0
        caught = (state.ball_x - paddle_x).abs() <= CATCH_RADIUS
        catch_fail = landing & ~caught
        ball_x = torch.where(landing, R.uniform(pair[..., 0, :], (), 0.1, 0.9),
                             state.ball_x)
        ball_y = ball_y.masked_fill(landing, 0.0)

        # DODGE minigame (the same action moves the lane).
        lane = (state.lane + move_i).clamp(0, 2)
        obs_y = state.obs_y + OBSTACLE_SPEED
        obs_landing = obs_y >= 1.0
        dodge_fail = obs_landing & (state.obs_lane == lane)
        obs_lane = torch.where(obs_landing,
                               R.randint(pair[..., 1, :], (), 0, 3),
                               state.obs_lane)
        obs_y = obs_y.masked_fill(obs_landing, 0.0)

        done = catch_fail | dodge_fail
        reward = torch.full(done.shape, ALIVE_REWARD, dtype=torch.float32,
                            device=done.device).masked_fill_(done, FAIL_REWARD)
        ns = MultitaskState(paddle_x, ball_x, ball_y, lane, obs_lane, obs_y,
                            state.t + 1)
        return Timestep(ns, self._obs(ns), reward, done, {})

    # -- rendering (capsule scene; see kernels/raster) -----------------------
    def scene(self, state: MultitaskState):
        """(..., 5, 5) capsules and (..., 5) intensities. Left half: catch
        (divider, paddle, ball); right half: dodge (player, obstacle)."""
        from repro_torch.kernels.raster import capsule_scene

        px = 0.05 + state.paddle_x * 0.40
        bx = 0.05 + state.ball_x * 0.40
        lane_x = 0.55 + div((state.lane.to(torch.float32) + 0.5) * 0.40, 3)
        obs_x = 0.55 + div((state.obs_lane.to(torch.float32) + 0.5) * 0.40, 3)
        return capsule_scene(state.ball_x, [
            (0.5, 0.0, 0.5, 1.0, 0.004),                              # divider
            (px - 0.06, 0.95, px + 0.06, 0.95, 0.02),                 # paddle
            (bx, state.ball_y, bx, state.ball_y, 0.025),              # ball
            (lane_x, 0.95, lane_x, 0.95, 0.03),                       # player
            (obs_x, state.obs_y, obs_x, state.obs_y, 0.03),           # obstacle
        ], (0.25, 0.8, 1.0, 0.8, 1.0))


__all__ = ["Multitask", "MultitaskState"]
