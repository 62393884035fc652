"""Pure-Python classic-control baselines — the "AI Gym" comparator.

Faithful ports of Gym's classic_control envs in interpreted Python (floats +
math, one step per call), exactly the execution model whose overhead the
paper measures (Fig. 1: CaiRL is ~5× faster console, ~80× faster rendering).
These share dynamics constants with the compiled envs so cross-validation
tests can assert trajectory equality.
"""
from __future__ import annotations

import math
import random

import numpy as np

from repro_torch.envs.baseline_python.raster import rasterize_np

FRAME = (84, 84)


class _BaselineEnv:
    """Classic-Gym-style stateful API."""

    n_actions: int | None = None  # discrete envs

    def __init__(self):
        self._rng = random.Random(0)

    def seed(self, seed: int):
        self._rng = random.Random(seed)

    def action_space_sample(self):
        if self.n_actions is None:
            raise NotImplementedError
        return self._rng.randrange(self.n_actions)

    def reset(self):
        raise NotImplementedError

    def step(self, action):
        raise NotImplementedError

    def scene(self):
        raise NotImplementedError

    def render(self):
        segs, intens = self.scene()
        return rasterize_np(np.asarray(segs, np.float32), np.asarray(intens, np.float32), *FRAME)


class CartPolePy(_BaselineEnv):
    n_actions = 2

    def reset(self):
        self.x, self.x_dot, self.theta, self.theta_dot = (
            self._rng.uniform(-0.05, 0.05) for _ in range(4)
        )
        self.steps = 0
        return self._obs()

    def set_state(self, state):
        self.x, self.x_dot = float(state.x), float(state.x_dot)
        self.theta, self.theta_dot = float(state.theta), float(state.theta_dot)
        self.steps = 0

    def _obs(self):
        return [self.x, self.x_dot, self.theta, self.theta_dot]

    def step(self, action):
        force = 10.0 if action == 1 else -10.0
        costheta, sintheta = math.cos(self.theta), math.sin(self.theta)
        temp = (force + 0.05 * self.theta_dot**2 * sintheta) / 1.1
        thetaacc = (9.8 * sintheta - costheta * temp) / (0.5 * (4.0 / 3.0 - 0.1 * costheta**2 / 1.1))
        xacc = temp - 0.05 * thetaacc * costheta / 1.1
        self.x += 0.02 * self.x_dot
        self.x_dot += 0.02 * xacc
        self.theta += 0.02 * self.theta_dot
        self.theta_dot += 0.02 * thetaacc
        self.steps += 1
        terminal = abs(self.x) > 2.4 or abs(self.theta) > 0.2095
        truncated = not terminal and self.steps >= 500
        return self._obs(), 1.0, terminal or truncated, {"truncated": truncated}

    def scene(self):
        cx = 0.5 + self.x / 4.8 * 0.8
        cy = 0.75
        tip_x = cx + math.sin(self.theta) * 0.35
        tip_y = cy - math.cos(self.theta) * 0.35
        segs = [
            [0.05, cy + 0.05, 0.95, cy + 0.05, 0.006],
            [cx - 0.07, cy, cx + 0.07, cy, 0.035],
            [cx, cy, tip_x, tip_y, 0.015],
        ]
        return segs, [0.35, 0.7, 1.0]


class MountainCarPy(_BaselineEnv):
    n_actions = 3

    def reset(self):
        self.position = self._rng.uniform(-0.6, -0.4)
        self.velocity = 0.0
        self.steps = 0
        return [self.position, self.velocity]

    def set_state(self, state):
        self.position = float(state.position)
        self.velocity = float(state.velocity)
        self.steps = 0

    def step(self, action):
        self.velocity += (action - 1) * 0.001 + math.cos(3 * self.position) * (-0.0025)
        self.velocity = max(min(self.velocity, 0.07), -0.07)
        self.position = max(min(self.position + self.velocity, 0.6), -1.2)
        if self.position <= -1.2 and self.velocity < 0:
            self.velocity = 0.0
        self.steps += 1
        terminal = self.position >= 0.5 and self.velocity >= 0.0
        truncated = not terminal and self.steps >= 200
        return [self.position, self.velocity], -1.0, terminal or truncated, \
            {"truncated": truncated}

    def scene(self):
        def to_xy(p):
            return ((p + 1.2) / 1.8 * 0.8 + 0.1, 0.9 - (math.sin(3 * p) * 0.45 + 0.55) * 0.6)

        ps = [(-1.2 + 1.8 * i / 6) for i in range(7)]
        pts = [to_xy(p) for p in ps]
        segs = [[*pts[i], *pts[i + 1], 0.006] for i in range(6)]
        cx, cy = to_xy(self.position)
        gx, gy = to_xy(0.5)
        segs += [[cx, cy - 0.03, cx, cy - 0.03, 0.03], [gx, gy - 0.10, gx, gy, 0.008]]
        return segs, [0.35] * 6 + [1.0, 0.7]


class AcrobotPy(_BaselineEnv):
    n_actions = 3

    def reset(self):
        self.s = [self._rng.uniform(-0.1, 0.1) for _ in range(4)]
        self.steps = 0
        return self._obs()

    def set_state(self, state):
        self.s = [float(state.theta1), float(state.theta2),
                  float(state.dtheta1), float(state.dtheta2)]
        self.steps = 0

    def _obs(self):
        t1, t2, d1, d2 = self.s
        return [math.cos(t1), math.sin(t1), math.cos(t2), math.sin(t2), d1, d2]

    @staticmethod
    def _dsdt(s, torque):
        theta1, theta2, dtheta1, dtheta2 = s
        d1 = 1 * 0.25 + 1 * (1 + 0.25 + 2 * 0.5 * math.cos(theta2)) + 2.0
        d2 = 1 * (0.25 + 0.5 * math.cos(theta2)) + 1.0
        phi2 = 1 * 0.5 * 9.8 * math.cos(theta1 + theta2 - math.pi / 2)
        phi1 = (
            -1 * 0.5 * dtheta2**2 * math.sin(theta2)
            - 2 * 0.5 * dtheta2 * dtheta1 * math.sin(theta2)
            + (0.5 + 1.0) * 9.8 * math.cos(theta1 - math.pi / 2)
            + phi2
        )
        ddtheta2 = (torque + d2 / d1 * phi1 - 0.5 * dtheta1**2 * math.sin(theta2) - phi2) / (
            0.25 + 1.0 - d2**2 / d1
        )
        ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
        return [dtheta1, dtheta2, ddtheta1, ddtheta2]

    def step(self, action):
        torque = [-1.0, 0.0, 1.0][action]
        s = self.s
        dt = 0.2
        k1 = self._dsdt(s, torque)
        k2 = self._dsdt([s[i] + dt / 2 * k1[i] for i in range(4)], torque)
        k3 = self._dsdt([s[i] + dt / 2 * k2[i] for i in range(4)], torque)
        k4 = self._dsdt([s[i] + dt * k3[i] for i in range(4)], torque)
        s = [s[i] + dt / 6 * (k1[i] + 2 * k2[i] + 2 * k3[i] + k4[i]) for i in range(4)]
        s[0] = ((s[0] + math.pi) % (2 * math.pi)) - math.pi
        s[1] = ((s[1] + math.pi) % (2 * math.pi)) - math.pi
        s[2] = max(min(s[2], 4 * math.pi), -4 * math.pi)
        s[3] = max(min(s[3], 9 * math.pi), -9 * math.pi)
        self.s = s
        self.steps += 1
        terminal = -math.cos(s[0]) - math.cos(s[1] + s[0]) > 1.0
        truncated = not terminal and self.steps >= 500
        return self._obs(), (0.0 if terminal else -1.0), terminal or truncated, \
            {"truncated": truncated}

    def scene(self):
        t1, t2 = self.s[0], self.s[1]
        ox, oy = 0.5, 0.45
        x1, y1 = ox + 0.22 * math.sin(t1), oy + 0.22 * math.cos(t1)
        x2, y2 = x1 + 0.22 * math.sin(t1 + t2), y1 + 0.22 * math.cos(t1 + t2)
        segs = [
            [0.1, oy - 0.22, 0.9, oy - 0.22, 0.004],
            [ox, oy, x1, y1, 0.02],
            [x1, y1, x2, y2, 0.02],
        ]
        return segs, [0.3, 0.8, 1.0]


class PendulumPy(_BaselineEnv):
    def reset(self):
        self.theta = self._rng.uniform(-math.pi, math.pi)
        self.theta_dot = self._rng.uniform(-1.0, 1.0)
        self.steps = 0
        return self._obs()

    def set_state(self, state):
        self.theta = float(state.theta)
        self.theta_dot = float(state.theta_dot)
        self.steps = 0

    def _obs(self):
        return [math.cos(self.theta), math.sin(self.theta), self.theta_dot]

    def action_space_sample(self):
        return [self._rng.uniform(-2.0, 2.0)]

    def step(self, action):
        u = max(min(float(action[0]), 2.0), -2.0)
        th, thdot = self.theta, self.theta_dot
        ang = ((th + math.pi) % (2 * math.pi)) - math.pi
        costs = ang**2 + 0.1 * thdot**2 + 0.001 * u**2
        newthdot = thdot + (3 * 10.0 / 2 * math.sin(th) + 3.0 * u) * 0.05
        newthdot = max(min(newthdot, 8.0), -8.0)
        self.theta = th + newthdot * 0.05
        self.theta_dot = newthdot
        self.steps += 1
        truncated = self.steps >= 200  # pendulum never self-terminates
        return self._obs(), -costs, truncated, {"truncated": truncated}

    def scene(self):
        ox, oy = 0.5, 0.5
        tx, ty = ox + 0.35 * math.sin(self.theta), oy - 0.35 * math.cos(self.theta)
        return [[ox, oy, tx, ty, 0.025], [ox, oy, ox, oy, 0.02]], [1.0, 0.5]
