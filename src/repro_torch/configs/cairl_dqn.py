"""The paper's own experiment configuration (Table I) + a tuned variant
(copy of `repro.configs.cairl_dqn`).

`PAPER_TABLE_I` reproduces the carbon-emission experiment exactly; `TUNED`
is the JAX package's configuration that reliably solves CartPole-v1, kept
apart so the faithful config stays intact.
"""
from repro_torch.rl.dqn import DQNConfig

# Table I: Discount 0.99 | Units 32,32 | elu | Adam | Huber | batch 32 |
# lr 3e-4 | target update 150 | memory 50 000 | eps 1.0 -> 0.01
PAPER_TABLE_I = DQNConfig(
    discount=0.99,
    units=(32, 32),
    activation="elu",
    batch_size=32,
    lr=3e-4,
    target_update_freq=150,
    memory_size=50_000,
    exploration_start=1.0,
    exploration_final=0.01,
)

TUNED = DQNConfig(
    discount=0.99,
    units=(64, 64),
    activation="elu",
    batch_size=64,
    lr=1e-3,
    target_update_freq=500,
    memory_size=50_000,
    exploration_start=1.0,
    exploration_final=0.01,
    exploration_steps=15_000,
    learn_start=500,
    num_envs=4,
)
