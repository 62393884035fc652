"""Acrobot-v1, Gym-faithful (book dynamics, RK4), batch-native (port of
`repro.envs.classic.acrobot`; same operation order)."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import random as R
from repro_torch.core.env import Env, Timestep
from repro_torch.core.spaces import Box, Discrete

DT = 0.2
L1 = 1.0
L2 = 1.0
M1 = 1.0
M2 = 1.0
LC1 = 0.5
LC2 = 0.5
I1 = 1.0
I2 = 1.0
G = 9.8
MAX_VEL_1 = 4 * math.pi
MAX_VEL_2 = 9 * math.pi


class AcrobotState(NamedTuple):
    theta1: torch.Tensor
    theta2: torch.Tensor
    dtheta1: torch.Tensor
    dtheta2: torch.Tensor


def _dsdt(s, torque):
    theta1, theta2, dtheta1, dtheta2 = s.unbind(-1)
    d1 = (
        M1 * LC1**2
        + M2 * (L1**2 + LC2**2 + 2 * L1 * LC2 * torch.cos(theta2))
        + I1 + I2
    )
    d2 = M2 * (LC2**2 + L1 * LC2 * torch.cos(theta2)) + I2
    phi2 = M2 * LC2 * G * torch.cos(theta1 + theta2 - math.pi / 2.0)
    phi1 = (
        -M2 * L1 * LC2 * (dtheta2 * dtheta2) * torch.sin(theta2)
        - 2 * M2 * L1 * LC2 * dtheta2 * dtheta1 * torch.sin(theta2)
        + (M1 * LC1 + M2 * L1) * G * torch.cos(theta1 - math.pi / 2)
        + phi2
    )
    # "book" dynamics (Gym default).
    ddtheta2 = (
        torque + d2 / d1 * phi1
        - M2 * L1 * LC2 * (dtheta1 * dtheta1) * torch.sin(theta2) - phi2
    ) / (M2 * LC2**2 + I2 - d2 * d2 / d1)
    ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
    return torch.stack([dtheta1, dtheta2, ddtheta1, ddtheta2], -1)


def _rk4(s, torque):
    k1 = _dsdt(s, torque)
    k2 = _dsdt(s + DT / 2 * k1, torque)
    k3 = _dsdt(s + DT / 2 * k2, torque)
    k4 = _dsdt(s + DT * k3, torque)
    return s + DT / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


def _wrap(x, lo, hi):
    # Floor-mod, as jnp.mod: torch.remainder, not fmod.
    return lo + torch.remainder(x - lo, hi - lo)


class Acrobot(Env):
    observation_space = Box(
        low=(-1.0, -1.0, -1.0, -1.0, -MAX_VEL_1, -MAX_VEL_2),
        high=(1.0, 1.0, 1.0, 1.0, MAX_VEL_1, MAX_VEL_2),
        shape=(6,),
    )
    action_space = Discrete(3)
    frame_shape = (84, 84)

    def reset(self, keys):
        vals = R.uniform(keys, (4,), -0.1, 0.1)
        state = AcrobotState(*vals.unbind(-1))
        return state, self._obs(state)

    @staticmethod
    def _obs(s: AcrobotState):
        return torch.stack([torch.cos(s.theta1), torch.sin(s.theta1),
                            torch.cos(s.theta2), torch.sin(s.theta2),
                            s.dtheta1, s.dtheta2], -1)

    def step(self, state: AcrobotState, action, key=None):
        torque = action - 1.0  # TORQUES = [-1, 0, 1]
        ns = _rk4(torch.stack(list(state), -1), torque)
        theta1 = _wrap(ns[..., 0], -math.pi, math.pi)
        theta2 = _wrap(ns[..., 1], -math.pi, math.pi)
        dtheta1 = ns[..., 2].clamp(-MAX_VEL_1, MAX_VEL_1)
        dtheta2 = ns[..., 3].clamp(-MAX_VEL_2, MAX_VEL_2)
        new = AcrobotState(theta1, theta2, dtheta1, dtheta2)
        done = (-torch.cos(theta1) - torch.cos(theta2 + theta1)) > 1.0
        reward = torch.full_like(theta1, -1.0).masked_fill_(done, 0.0)
        return Timestep(new, self._obs(new), reward, done, {})

    # -- rendering (capsule scene; see kernels/raster) -----------------------
    def scene(self, state: AcrobotState):
        """Goal line and the two links: (..., 3, 5) and (..., 3)."""
        from repro_torch.kernels.raster import capsule_scene

        ox, oy = 0.5, 0.45
        x1 = ox + 0.22 * torch.sin(state.theta1)
        y1 = oy + 0.22 * torch.cos(state.theta1)
        x2 = x1 + 0.22 * torch.sin(state.theta1 + state.theta2)
        y2 = y1 + 0.22 * torch.cos(state.theta1 + state.theta2)
        return capsule_scene(state.theta1, [
            (0.1, oy - 0.22, 0.9, oy - 0.22, 0.004),          # goal line
            (ox, oy, x1, y1, 0.02),
            (x1, y1, x2, y2, 0.02),
        ], (0.3, 0.8, 1.0))
