"""Pendulum-v1, Gym-faithful, batch-native (port of
`repro.envs.classic.pendulum`; same operation order)."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import random as R
from repro_torch.core.env import Env, Timestep
from repro_torch.core.spaces import Box

MAX_SPEED = 8.0
MAX_TORQUE = 2.0
DT = 0.05
G = 10.0
M = 1.0
L = 1.0


def _angle_normalize(x):
    # Floor-mod, as Python `%` on a jax array: torch.remainder, not fmod.
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


class PendulumState(NamedTuple):
    theta: torch.Tensor
    theta_dot: torch.Tensor


class Pendulum(Env):
    observation_space = Box(low=(-1.0, -1.0, -MAX_SPEED),
                            high=(1.0, 1.0, MAX_SPEED), shape=(3,))
    action_space = Box(low=-MAX_TORQUE, high=MAX_TORQUE, shape=(1,))
    frame_shape = (84, 84)

    def reset(self, keys):
        pair = R.split(keys)
        theta = R.uniform(pair[..., 0, :], (), -math.pi, math.pi)
        theta_dot = R.uniform(pair[..., 1, :], (), -1.0, 1.0)
        state = PendulumState(theta, theta_dot)
        return state, self._obs(state)

    @staticmethod
    def _obs(s):
        return torch.stack([torch.cos(s.theta), torch.sin(s.theta), s.theta_dot],
                           -1)

    def step(self, state: PendulumState, action, key=None):
        # (B, 1) actions from the pool, (B,) action rows from the megastep
        u = action.reshape(state.theta.shape).clamp(-MAX_TORQUE, MAX_TORQUE)
        th, thdot = state.theta, state.theta_dot
        an = _angle_normalize(th)
        costs = an * an + 0.1 * (thdot * thdot) + 0.001 * (u * u)
        newthdot = thdot + (3 * G / (2 * L) * torch.sin(th)
                            + 3.0 / (M * L * L) * u) * DT
        newthdot = newthdot.clamp(-MAX_SPEED, MAX_SPEED)
        newth = th + newthdot * DT
        ns = PendulumState(newth, newthdot)
        return Timestep(ns, self._obs(ns), -costs,
                        torch.zeros_like(th, dtype=torch.bool), {})

    # -- rendering (capsule scene; see kernels/raster) -----------------------
    def scene(self, state: PendulumState):
        """Rod and pivot: (..., 2, 5) and (..., 2)."""
        from repro_torch.kernels.raster import capsule_scene

        ox, oy = 0.5, 0.5
        tx = ox + 0.35 * torch.sin(state.theta)
        ty = oy - 0.35 * torch.cos(state.theta)
        return capsule_scene(state.theta, [
            (ox, oy, tx, ty, 0.025),
            (ox, oy, ox, oy, 0.02),
        ], (1.0, 0.5))
