"""Procedural gridworld suite, batch-native (port of `repro.envs.grid`):
FrozenLake, CliffWalk, Maze and Snake, each drawing its level anew in
`reset` from the lane's key."""
from repro_torch.envs.grid.cliff_walk import CliffWalk
from repro_torch.envs.grid.frozen_lake import FrozenLake
from repro_torch.envs.grid.maze import Maze
from repro_torch.envs.grid.snake import Snake

__all__ = ["CliffWalk", "FrozenLake", "Maze", "Snake"]
