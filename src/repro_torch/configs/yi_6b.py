"""yi-6b — llama-arch GQA dense decoder [arXiv:2403.04652; hf].

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="yi-6b", family="dense",
        d_model=4096, num_heads=32, num_kv_heads=4, head_dim=128,
        d_ff=11008, vocab_size=64000,
        segments=((("full",), 32),),
        rope_theta=10_000.0, tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="yi-6b-reduced", family="dense",
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=176, vocab_size=512,
        segments=((("full",), 2),),
        tie_embeddings=False, dtype="float32",
    )
