"""gemma3-27b — 5:1 local:global attention, 128k context
[hf:google/gemma-3-* family; unverified].

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144, head_dim=128,
local window=1024, qk-norm. Stack = 10 × (5 local + 1 global) + 2 local.
The two-tier KV cache (ring caches for the 52 local layers, full-depth for
the 10 global ones) is what makes the long_500k cell fit (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b", family="dense",
        d_model=5376, num_heads=32, num_kv_heads=16, head_dim=128,
        d_ff=21504, vocab_size=262144,
        segments=(
            (("swa", "swa", "swa", "swa", "swa", "full"), 10),
            (("swa",), 2),
        ),
        window=1024, qk_norm=True, rope_theta=1_000_000.0,
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b-reduced", family="dense",
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=512,
        segments=((("swa", "swa", "full"), 2),),
        window=8, qk_norm=True, tie_embeddings=True, dtype="float32",
    )
