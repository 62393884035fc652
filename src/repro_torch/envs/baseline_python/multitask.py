"""Pure-Python Multitask baseline (interpreted execution model)."""
from __future__ import annotations

from repro_torch.envs.baseline_python.classic import _BaselineEnv


class MultitaskPy(_BaselineEnv):
    n_actions = 3

    def reset(self):
        self.paddle_x = 0.5
        self.ball_x = self._rng.uniform(0.1, 0.9)
        self.ball_y = 0.0
        self.lane = 1
        self.obs_lane = self._rng.randrange(3)
        self.obs_y = 0.0
        self.steps = 0
        return self._obs()

    def set_state(self, state):
        self.paddle_x = float(state.paddle_x)
        self.ball_x, self.ball_y = float(state.ball_x), float(state.ball_y)
        self.lane, self.obs_lane = int(state.lane), int(state.obs_lane)
        self.obs_y = float(state.obs_y)
        self.steps = 0

    def _obs(self):
        lane_oh = [1.0 if self.lane == i else 0.0 for i in range(3)]
        obs_oh = [1.0 if self.obs_lane == i else 0.0 for i in range(3)]
        return [self.paddle_x, self.ball_x, self.ball_y, self.obs_y] + lane_oh + obs_oh

    def step(self, action):
        move = action - 1
        self.paddle_x = max(min(self.paddle_x + move * 0.07, 0.95), 0.05)
        self.ball_y += 0.05
        catch_fail = False
        if self.ball_y >= 1.0:
            catch_fail = abs(self.ball_x - self.paddle_x) > 0.13
            self.ball_x = self._rng.uniform(0.1, 0.9)
            self.ball_y = 0.0
        self.lane = max(min(self.lane + move, 2), 0)
        self.obs_y += 0.04
        dodge_fail = False
        if self.obs_y >= 1.0:
            dodge_fail = self.obs_lane == self.lane
            self.obs_lane = self._rng.randrange(3)
            self.obs_y = 0.0
        self.steps += 1
        terminal = catch_fail or dodge_fail
        truncated = not terminal and self.steps >= 1000
        reward = -10.0 if terminal else 1.0
        return self._obs(), reward, terminal or truncated, {"truncated": truncated}

    def scene(self):
        px = 0.05 + self.paddle_x * 0.40
        bx = 0.05 + self.ball_x * 0.40
        lane_x = 0.55 + (self.lane + 0.5) * 0.40 / 3
        obs_x = 0.55 + (self.obs_lane + 0.5) * 0.40 / 3
        segs = [
            [0.5, 0.0, 0.5, 1.0, 0.004],
            [px - 0.06, 0.95, px + 0.06, 0.95, 0.02],
            [bx, self.ball_y, bx, self.ball_y, 0.025],
            [lane_x, 0.95, lane_x, 0.95, 0.03],
            [obs_x, self.obs_y, obs_x, self.obs_y, 0.03],
        ]
        return segs, [0.25, 0.8, 1.0, 0.8, 1.0]
