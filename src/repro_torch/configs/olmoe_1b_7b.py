"""olmoe-1b-7b — 64-expert top-8 MoE [arXiv:2409.02060; hf].

16L d_model=2048 16H (kv=16) per-expert d_ff=1024 vocab=50304.
"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
        d_ff=1024, vocab_size=50304,
        segments=((("full_moe",), 16),),
        num_experts=64, num_experts_per_tok=8, capacity_factor=1.25,
        tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-reduced", family="moe",
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=32, vocab_size=512,
        segments=((("full_moe",), 2),),
        num_experts=8, num_experts_per_tok=2, capacity_factor=2.0,
        tie_embeddings=False, dtype="float32",
    )
