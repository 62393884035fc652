"""MountainCar-v0, Gym-faithful, batch-native (port of
`repro.envs.classic.mountain_car`; same operation order)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random as R
from repro_torch.core.env import Env, Timestep
from repro_torch.core.spaces import Box, Discrete

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

    def reset(self, keys):
        pos = R.uniform(keys, (), -0.6, -0.4)
        state = MountainCarState(pos, torch.zeros_like(pos))
        return state, self._obs(state)

    @staticmethod
    def _obs(s):
        return torch.stack([s.position, s.velocity], -1)

    def step(self, state: MountainCarState, action):
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
