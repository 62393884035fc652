"""zamba2-2.7b — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf].

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64.
Stack = 6 × (8 Mamba2 + shared-attn site); the attention+FFN weights are
SHARED across the 6 sites (zamba2's parameter-reuse trick) — per-site LoRA
deltas are omitted (DESIGN.md simplifications).
"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
        d_ff=10240, vocab_size=32000,
        segments=(((("mamba2",) * 8 + ("attn_shared",)), 6),),
        ssm_state=64, ssm_chunk=256, expand=2,
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-reduced", family="hybrid",
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
        segments=((("mamba2", "mamba2", "attn_shared"), 2),),
        ssm_state=8, ssm_chunk=8, expand=2, tie_embeddings=True, dtype="float32",
    )
