"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24L d_model=1024 4H d_ff=0 (xLSTM blocks carry their own projections)
vocab=50304. Stack = 3 × (7 mLSTM + 1 sLSTM) (the paper's sparse-sLSTM
placement). Recurrent state is O(1) in sequence → long_500k runs.
"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm",
        d_model=1024, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304,
        segments=(((("mlstm",) * 7 + ("slstm",)), 3),),
        expand=2, ssm_chunk=256, tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m-reduced", family="ssm",
        d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=512,
        segments=((("mlstm", "mlstm", "slstm"), 2),),
        expand=2, ssm_chunk=8, tie_embeddings=True, dtype="float32",
    )
