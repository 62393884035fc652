"""whisper-base — encoder-decoder ASR backbone [arXiv:2212.04356; unverified].

6L encoder + 6L decoder, d_model=512 8H d_ff=2048 vocab=51865. The conv
log-mel frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, 1500, d). RMSNorm replaces LayerNorm (DESIGN.md
simplifications); decode shapes exercise the decoder with self- and
cross-attention caches.
"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio",
        d_model=512, num_heads=8, num_kv_heads=8, head_dim=64,
        d_ff=2048, vocab_size=51865,
        segments=((("dec",), 6),),
        encoder_segments=((("enc",), 6),),
        encoder_len=1500, tie_embeddings=True, frontend="audio_frames",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-base-reduced", family="audio",
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
        segments=((("dec",), 2),),
        encoder_segments=((("enc",), 2),),
        encoder_len=24, tie_embeddings=True, frontend="audio_frames", dtype="float32",
    )
