"""Built-in environments. Importing this module registers the Gym-named ids.

Each family gives a `-v<N>` id and a `-raw` id (the bare core), with the
JAX package's ids and limits. Classic control's `-v<N>` is Gym's default
TimeLimit; the arcade games' `-v0` observes 4 stacked 84×84 frames rendered
on the device (paper §IV-C), their `-raw` the state vector. The grid
suite's `-v0` observes the cell-code grid, and its `-px` ids 4 stacked
84×84 renders of the same scene.
"""
from repro_torch.core.registry import register_family
from repro_torch.envs.arcade import Breakout, Pong
from repro_torch.envs.classic import Acrobot, CartPole, MountainCar, Pendulum
from repro_torch.envs.grid import CliffWalk, FrozenLake, Maze, Snake
from repro_torch.envs.multitask import Multitask
from repro_torch.envs.puzzle import LightsOut

register_family("CartPole", CartPole, max_steps=500, version=1,
                tags=("classic",))
register_family("Acrobot", Acrobot, max_steps=500, version=1,
                tags=("classic",))
register_family("MountainCar", MountainCar, max_steps=200, tags=("classic",))
register_family("Pendulum", Pendulum, max_steps=200, version=1,
                tags=("classic",))

# The paper's flagship Flash game (§IV-C) and puzzle runtime (§IV-D).
register_family("Multitask", Multitask, max_steps=1000, tags=("flash",))
register_family("LightsOut", LightsOut, max_steps=100, tags=("puzzle",))

register_family("Pong", Pong, max_steps=1000, obs="pixels", tags=("arcade",))
register_family("Breakout", Breakout, max_steps=1000, obs="pixels",
                tags=("arcade",))

# The procedural gridworld suite: the level is drawn anew every episode.
register_family("FrozenLake", FrozenLake, max_steps=100, pixel_variant=True,
                tags=("grid",))
register_family("CliffWalk", CliffWalk, max_steps=100, pixel_variant=True,
                tags=("grid",))
register_family("Snake", Snake, max_steps=200, pixel_variant=True,
                tags=("grid",))
register_family("Maze", Maze, max_steps=200, pixel_variant=True,
                tags=("grid",))

__all__ = ["Acrobot", "Breakout", "CartPole", "CliffWalk", "FrozenLake",
           "LightsOut", "Maze", "MountainCar", "Multitask", "Pendulum",
           "Pong", "Snake"]
