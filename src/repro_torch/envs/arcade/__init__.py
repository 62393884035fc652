from repro_torch.envs.arcade.breakout import Breakout
from repro_torch.envs.arcade.pong import Pong

__all__ = ["Breakout", "Pong"]
