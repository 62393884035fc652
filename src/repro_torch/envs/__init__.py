"""Built-in environments. Importing this module registers the Gym-named ids.

Each family gives a `-v<N>` id and a `-raw` id (the bare core), with the
JAX package's ids and limits. Classic control's `-v<N>` is Gym's default
TimeLimit; the arcade games' `-v0` observes 4 stacked 84×84 frames rendered
on the device (paper §IV-C), their `-raw` the state vector. The grid,
puzzle and multitask families come with their slice (ROADMAP A9).
"""
from repro_torch.core.registry import register_family
from repro_torch.envs.arcade import Breakout, Pong
from repro_torch.envs.classic import Acrobot, CartPole, MountainCar, Pendulum

register_family("CartPole", CartPole, max_steps=500, version=1)
register_family("Acrobot", Acrobot, max_steps=500, version=1)
register_family("MountainCar", MountainCar, max_steps=200)
register_family("Pendulum", Pendulum, max_steps=200, version=1)

register_family("Pong", Pong, max_steps=1000, obs="pixels")
register_family("Breakout", Breakout, max_steps=1000, obs="pixels")

__all__ = ["Acrobot", "Breakout", "CartPole", "MountainCar", "Pendulum",
           "Pong"]
