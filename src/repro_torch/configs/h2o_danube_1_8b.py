"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; hf].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, window=4096.
"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", family="dense",
        d_model=2560, num_heads=32, num_kv_heads=8, head_dim=80,
        d_ff=6912, vocab_size=32000,
        segments=((("swa",), 24),),
        window=4096, tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b-reduced", family="dense",
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=112, vocab_size=512,
        segments=((("swa",), 2),),
        window=8, tie_embeddings=False, dtype="float32",
    )
