"""Pong, batch-native (port of `repro.envs.arcade.pong`; same operation
order, constants copied).

Single-player Pong against a scripted tracking opponent: the agent drives
the right paddle (Discrete(3): up/stay/down), the episode is one rally, +1
when the ball passes the opponent and -1 when it passes the agent.
Coordinates are the rasteriser's [0, 1]², x rightward, y downward. The
observation is the state vector; the registered `Pong-v0` id observes 4
stacked 84×84 renders of `scene()` instead. The CUDA body in
csrc/megastep.cu repeats `step` and `reset`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random as R
from repro_torch.core.env import Env, Timestep
from repro_torch.core.spaces import Box, Discrete

PADDLE_HALF = 0.12     # paddle half-height
PADDLE_SPEED = 0.05    # agent paddle speed per step
OPP_SPEED = 0.03       # opponent tracking speed cap (slower => beatable)
BALL_SPEED_X = 0.035   # horizontal ball speed (constant magnitude)
SPIN = 0.25            # vertical deflection per unit of paddle-centre offset
MAX_VY = 0.05          # vertical ball speed cap
PLAYER_X = 0.92        # agent paddle plane (right)
OPP_X = 0.08           # opponent paddle plane (left)


class PongState(NamedTuple):
    ball_x: torch.Tensor
    ball_y: torch.Tensor
    ball_vx: torch.Tensor
    ball_vy: torch.Tensor
    player_y: torch.Tensor
    opp_y: torch.Tensor


def _paddle_hit(vx, vy, nx, ny, paddle_y, hit, plane):
    """Reflect the ball off a paddle plane where `hit`, with spin."""
    vy = torch.where(hit, (vy + (ny - paddle_y) * SPIN).clamp(-MAX_VY, MAX_VY),
                     vy)
    return (torch.where(hit, -vx, vx), vy,
            torch.where(hit, 2.0 * plane - nx, nx))


class Pong(Env):
    observation_space = Box(low=(0.0, 0.0, -1.0, -1.0, 0.0, 0.0),
                            high=(1.0, 1.0, 1.0, 1.0, 1.0, 1.0), shape=(6,))
    action_space = Discrete(3)
    frame_shape = (84, 84)

    def reset(self, keys):
        ks = R.split(keys, 3)
        ky, kd, kv = ks[..., 0, :], ks[..., 1, :], ks[..., 2, :]
        ball_y = R.uniform(ky, (), 0.3, 0.7)
        half = lambda: torch.full_like(ball_y, 0.5)
        serve = torch.full_like(ball_y, -1.0).masked_fill_(R.bernoulli(kd), 1.0)
        state = PongState(half(), ball_y, BALL_SPEED_X * serve,
                          R.uniform(kv, (), -0.02, 0.02), half(), half())
        return state, self._obs(state)

    @staticmethod
    def _obs(s: PongState):
        # obs == flattened state, in flatten-row order (fused-spec contract)
        return torch.stack(list(s), -1)

    def step(self, state: PongState, action, key=None):
        move = (action - 1).to(torch.float32)  # {-1, 0, +1}
        player_y = (state.player_y + move * PADDLE_SPEED).clamp(
            PADDLE_HALF, 1.0 - PADDLE_HALF)
        opp_y = state.opp_y + (state.ball_y - state.opp_y).clamp(-OPP_SPEED,
                                                                 OPP_SPEED)
        opp_y = opp_y.clamp(PADDLE_HALF, 1.0 - PADDLE_HALF)

        nx = state.ball_x + state.ball_vx
        ny = state.ball_y + state.ball_vy
        vx, vy = state.ball_vx, state.ball_vy
        # top/bottom wall bounce (reflect position and velocity)
        vy = torch.where((ny < 0.0) | (ny > 1.0), -vy, vy)
        ny = torch.where(ny < 0.0, -ny, ny)
        ny = torch.where(ny > 1.0, 2.0 - ny, ny)
        # agent paddle (right plane): reflect on crossing within paddle reach
        hit_p = ((state.ball_x < PLAYER_X) & (nx >= PLAYER_X)
                 & ((ny - player_y).abs() <= PADDLE_HALF))
        vx, vy, nx = _paddle_hit(vx, vy, nx, ny, player_y, hit_p, PLAYER_X)
        # opponent paddle (left plane)
        hit_o = ((state.ball_x > OPP_X) & (nx <= OPP_X)
                 & ((ny - opp_y).abs() <= PADDLE_HALF))
        vx, vy, nx = _paddle_hit(vx, vy, nx, ny, opp_y, hit_o, OPP_X)

        score_p = nx < 0.0   # past the opponent: agent point
        score_o = nx > 1.0   # past the agent: opponent point
        ns = PongState(nx, ny, vx, vy, player_y, opp_y)
        return Timestep(ns, self._obs(ns),
                        score_p.to(torch.float32) - score_o.to(torch.float32),
                        score_p | score_o, {})

    # -- rendering (capsule scene; see kernels/raster) -----------------------
    def scene(self, state: PongState):
        """(..., 4, 5) capsules and (..., 4) intensities: net, opponent,
        agent, ball."""
        from repro_torch.kernels.raster import capsule_scene

        return capsule_scene(state.ball_x, [
            (0.5, 0.02, 0.5, 0.98, 0.004),                            # net
            (OPP_X, state.opp_y - PADDLE_HALF, OPP_X,
             state.opp_y + PADDLE_HALF, 0.02),                       # opponent
            (PLAYER_X, state.player_y - PADDLE_HALF, PLAYER_X,
             state.player_y + PADDLE_HALF, 0.02),                    # agent
            (state.ball_x, state.ball_y, state.ball_x, state.ball_y,
             0.022),                                                 # ball
        ], (0.25, 0.7, 1.0, 0.9))
