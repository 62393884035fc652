"""chameleon-34b — early-fusion VLM, VQ image tokens [arXiv:2405.09818; unverified].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 (text + VQ image
codes in one table). The VQ tokenizer frontend is a STUB: input_specs()
supplies already-tokenised mixed streams (frontend="vq_tokens"); qk-norm as
in the paper.
"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", family="vlm",
        d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
        d_ff=22016, vocab_size=65536,
        segments=((("full",), 48),),
        qk_norm=True, tie_embeddings=False, frontend="vq_tokens",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b-reduced", family="vlm",
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=176, vocab_size=512,
        segments=((("full",), 2),),
        qk_norm=True, tie_embeddings=False, frontend="vq_tokens", dtype="float32",
    )
