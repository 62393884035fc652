"""Interpreted-Python baselines ("AI Gym" comparator in the paper's Fig. 1/2).

The port's own copy of the JAX package's `repro.envs.baseline_python`
(numpy and `math` only), so the port's learner and benchmark scripts need
nothing of that package. The dynamics constants come from the port's envs.
"""
from repro_torch.envs.baseline_python.arcade import BreakoutPy, PongPy
from repro_torch.envs.baseline_python.classic import AcrobotPy, CartPolePy, MountainCarPy, PendulumPy
from repro_torch.envs.baseline_python.grid import CliffWalkPy, FrozenLakePy, MazePy, SnakePy
from repro_torch.envs.baseline_python.multitask import MultitaskPy

BASELINES = {
    "CartPole-v1": CartPolePy,
    "Acrobot-v1": AcrobotPy,
    "MountainCar-v0": MountainCarPy,
    "Pendulum-v1": PendulumPy,
    "Multitask-v0": MultitaskPy,
    "Pong-v0": PongPy,
    "Breakout-v0": BreakoutPy,
    "FrozenLake-v0": FrozenLakePy,
    "CliffWalk-v0": CliffWalkPy,
    "Snake-v0": SnakePy,
    "Maze-v0": MazePy,
}

__all__ = ["CartPolePy", "AcrobotPy", "MountainCarPy", "PendulumPy",
           "MultitaskPy", "PongPy", "BreakoutPy", "FrozenLakePy",
           "CliffWalkPy", "SnakePy", "MazePy", "BASELINES"]
