"""Built-in environments. Importing this module registers the Gym-named ids.

Classic control only so far: each family gives a `-v<N>` id (Gym's default
TimeLimit) and a `-raw` id (the bare core), with the JAX package's ids and
limits. The other families come with their slices (ROADMAP A8, A9).
"""
from repro_torch.core.registry import register_family
from repro_torch.envs.classic import Acrobot, CartPole, MountainCar, Pendulum

register_family("CartPole", CartPole, max_steps=500, version=1)
register_family("Acrobot", Acrobot, max_steps=500, version=1)
register_family("MountainCar", MountainCar, max_steps=200)
register_family("Pendulum", Pendulum, max_steps=200, version=1)

__all__ = ["Acrobot", "CartPole", "MountainCar", "Pendulum"]
