from repro_torch.envs.classic.acrobot import Acrobot
from repro_torch.envs.classic.cartpole import CartPole
from repro_torch.envs.classic.mountain_car import MountainCar
from repro_torch.envs.classic.pendulum import Pendulum

__all__ = ["Acrobot", "CartPole", "MountainCar", "Pendulum"]
