"""minicpm3-4b — MLA dense decoder [hf:openbmb/MiniCPM3-4B; hf].

62L d_model=2560 40H (kv=40) d_ff=6400 vocab=73448; MLA ranks from the HF
config: q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64.
"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b", family="dense",
        d_model=2560, num_heads=40, num_kv_heads=40,
        d_ff=6400, vocab_size=73448,
        segments=((("mla",), 62),),
        q_lora_rank=768, kv_lora_rank=256,
        qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64,
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b-reduced", family="dense",
        d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=160, vocab_size=512,
        segments=((("mla",), 2),),
        q_lora_rank=32, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        tie_embeddings=True, dtype="float32",
    )
