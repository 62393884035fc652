"""MountainCar-v0, Gym-faithful, batch-native (port of
`repro.envs.classic.mountain_car`; same operation order)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random as R
from repro_torch.core.env import Env, Timestep
from repro_torch.core.spaces import Box, Discrete
from repro_torch.numerics import div

MIN_POS = -1.2
MAX_POS = 0.6
MAX_SPEED = 0.07
GOAL_POS = 0.5
GOAL_VEL = 0.0
FORCE = 0.001
GRAVITY = 0.0025


class MountainCarState(NamedTuple):
    position: torch.Tensor
    velocity: torch.Tensor


class MountainCar(Env):
    observation_space = Box(low=(MIN_POS, -MAX_SPEED), high=(MAX_POS, MAX_SPEED),
                            shape=(2,))
    action_space = Discrete(3)
    frame_shape = (84, 84)

    def reset(self, keys):
        pos = R.uniform(keys, (), -0.6, -0.4)
        state = MountainCarState(pos, torch.zeros_like(pos))
        return state, self._obs(state)

    @staticmethod
    def _obs(s):
        return torch.stack([s.position, s.velocity], -1)

    def step(self, state: MountainCarState, action, key=None):
        velocity = (state.velocity + (action - 1) * FORCE
                    + torch.cos(3 * state.position) * (-GRAVITY))
        velocity = velocity.clamp(-MAX_SPEED, MAX_SPEED)
        position = (state.position + velocity).clamp(MIN_POS, MAX_POS)
        velocity = velocity.masked_fill((position <= MIN_POS) & (velocity < 0),
                                        0.0)
        ns = MountainCarState(position, velocity)
        done = (position >= GOAL_POS) & (velocity >= GOAL_VEL)
        return Timestep(ns, self._obs(ns), torch.full_like(position, -1.0),
                        done, {})

    # -- rendering (capsule scene; see kernels/raster) -----------------------
    def scene(self, state: MountainCarState):
        """Six terrain segments, the car and the flag: (..., 8, 5)."""
        from repro_torch.kernels.raster import capsule_scene

        def to_xy(p):
            x = div(p - MIN_POS, MAX_POS - MIN_POS) * 0.8 + 0.1
            y = 0.9 - (torch.sin(3 * p) * 0.45 + 0.55) * 0.6
            return x, y

        pos = state.position
        xs, ys = to_xy(torch.linspace(MIN_POS, MAX_POS, 7, device=pos.device))
        cx, cy = to_xy(pos)
        gx, gy = to_xy(torch.full_like(pos, GOAL_POS))
        return capsule_scene(pos, [
            *((xs[i], ys[i], xs[i + 1], ys[i + 1], 0.006) for i in range(6)),
            (cx, cy - 0.03, cx, cy - 0.03, 0.03),             # car dot
            (gx, gy - 0.10, gx, gy, 0.008),                   # flag pole
        ], (0.35,) * 6 + (1.0, 0.7))
