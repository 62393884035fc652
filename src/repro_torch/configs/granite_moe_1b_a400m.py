"""granite-moe-1b-a400m — 32-expert top-8 MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

24L d_model=1024 16H (GQA kv=8) per-expert d_ff=512 vocab=49155.
"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        d_model=1024, num_heads=16, num_kv_heads=8, head_dim=64,
        d_ff=512, vocab_size=49155,
        segments=((("full_moe",), 24),),
        num_experts=32, num_experts_per_tok=8, capacity_factor=1.25,
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m-reduced", family="moe",
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=512,
        segments=((("full_moe",), 2),),
        num_experts=8, num_experts_per_tok=2, capacity_factor=2.0,
        tie_embeddings=True, dtype="float32",
    )
