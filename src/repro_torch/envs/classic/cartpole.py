"""CartPole-v1, Gym-faithful dynamics, batch-native (port of
`repro.envs.classic.cartpole`).

Every formula keeps the operation order of the JAX module, and every
constant is computed in double as there and rounded to float32 once, when
an op meets a float32 tensor. The CUDA body in csrc/megastep.cu repeats it.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import random as R
from repro_torch.core.env import Env, Timestep
from repro_torch.core.spaces import Box, Discrete
from repro_torch.numerics import div as _div

# Gym constants (gym.envs.classic_control.cartpole).
GRAVITY = 9.8
MASSCART = 1.0
MASSPOLE = 0.1
TOTAL_MASS = MASSCART + MASSPOLE
LENGTH = 0.5               # half pole length
POLEMASS_LENGTH = MASSPOLE * LENGTH
FORCE_MAG = 10.0
TAU = 0.02
THETA_THRESHOLD = 12 * 2 * math.pi / 360
X_THRESHOLD = 2.4


class CartPoleState(NamedTuple):
    x: torch.Tensor
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor


class CartPole(Env):
    observation_space = Box(
        low=(-4.8, -math.inf, -0.418, -math.inf),
        high=(4.8, math.inf, 0.418, math.inf),
        shape=(4,),
    )
    action_space = Discrete(2)
    frame_shape = (84, 84)

    def reset(self, keys):
        vals = R.uniform(keys, (4,), -0.05, 0.05)
        state = CartPoleState(*vals.unbind(-1))
        return state, self._obs(state)

    @staticmethod
    def _obs(s: CartPoleState):
        return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], -1)

    def step(self, state: CartPoleState, action, key=None):
        force = torch.full_like(state.x, -FORCE_MAG).masked_fill_(action == 1,
                                                                  FORCE_MAG)
        costheta, sintheta = torch.cos(state.theta), torch.sin(state.theta)
        temp = _div(force + POLEMASS_LENGTH * (state.theta_dot * state.theta_dot)
                    * sintheta, TOTAL_MASS)
        thetaacc = (GRAVITY * sintheta - costheta * temp) / (
            LENGTH * (4.0 / 3.0 - _div(MASSPOLE * (costheta * costheta),
                                       TOTAL_MASS))
        )
        xacc = temp - _div(POLEMASS_LENGTH * thetaacc * costheta, TOTAL_MASS)
        # Euler, kinematics_integrator == "euler"
        x = state.x + TAU * state.x_dot
        x_dot = state.x_dot + TAU * xacc
        theta = state.theta + TAU * state.theta_dot
        theta_dot = state.theta_dot + TAU * thetaacc
        ns = CartPoleState(x, x_dot, theta, theta_dot)
        done = (x.abs() > X_THRESHOLD) | (theta.abs() > THETA_THRESHOLD)
        return Timestep(ns, self._obs(ns), torch.ones_like(x), done, {})

    # -- rendering (capsule scene; see kernels/raster) -----------------------
    def scene(self, state: CartPoleState):
        """Track, cart and pole: (..., 3, 5) and (..., 3)."""
        from repro_torch.kernels.raster import capsule_scene

        cx = 0.5 + _div(state.x, 2 * X_THRESHOLD) * 0.8  # [-2.4,2.4] -> [0.1,0.9]
        cy = torch.full_like(state.x, 0.75)
        tip_x = cx + torch.sin(state.theta) * 0.35
        tip_y = cy - torch.cos(state.theta) * 0.35
        return capsule_scene(state.x, [
            (0.05, cy + 0.05, 0.95, cy + 0.05, 0.006),       # track
            (cx - 0.07, cy, cx + 0.07, cy, 0.035),           # cart
            (cx, cy, tip_x, tip_y, 0.015),                   # pole
        ], (0.35, 0.7, 1.0))
