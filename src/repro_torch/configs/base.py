"""Model/shape configuration schema shared by all 10 assigned architectures
(a copy of `repro.configs.base`: plain dataclasses, no JAX).

A model is a sequence of SEGMENTS. Each segment is (block_types, repeat):
the `block_types` tuple is applied in order, and the pattern repeats
`repeat` times with parameters stacked along a leading axis (the JAX
package scans over it; the port loops over it). Heterogeneous stacks (gemma3 5:1
local:global, zamba2 Mamba2+shared-attn, xlstm mLSTM/sLSTM) are expressed as
multi-block segments.

Block type vocabulary:
  "full"      GQA full causal attention + dense SwiGLU FFN
  "swa"       GQA sliding-window attention + dense SwiGLU FFN
  "mla"       Multi-head Latent Attention (DeepSeek/MiniCPM3) + dense FFN
  "full_moe"  GQA full attention + top-k MoE FFN
  "mlstm"     xLSTM matrix-memory block (chunked gated linear attention)
  "slstm"     xLSTM scalar-memory recurrent block
  "mamba2"    Mamba2 SSD block (chunked scan + short conv + gate)
  "attn_shared" zamba2-style attention block with SHARED weights across sites
  "enc"       bidirectional encoder attention + FFN (whisper encoder)
  "dec"       causal self-attn + cross-attn + FFN (whisper decoder)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

Segment = Tuple[Tuple[str, ...], int]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | ssm | hybrid | moe | vlm | audio
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    segments: Tuple[Segment, ...]
    head_dim: Optional[int] = None
    # attention
    window: int = 0                  # sliding-window size for "swa" blocks
    rope_theta: float = 10_000.0
    qk_norm: bool = False            # chameleon/gemma3-style qk layernorm
    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mla_absorb: bool = False     # weight-absorbed latent attention (§Perf)
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 0          # >1 = shard-local grouped dispatch (§Perf)
    # SSM
    ssm_state: int = 0               # N (state size per head) for mamba2
    ssm_chunk: int = 256             # chunk length for the chunked scan
    conv_width: int = 4              # mamba2 short-conv width
    expand: int = 2                  # mamba2/mLSTM up-projection factor
    # encoder-decoder (whisper)
    encoder_segments: Tuple[Segment, ...] = ()
    encoder_len: int = 1500          # stub frontend frame count
    # misc
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"
    tie_embeddings: bool = True
    frontend: str = "none"           # none | audio_frames (stub) | vq_tokens (stub)

    # -- derived -------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def num_layers(self) -> int:
        return sum(len(blocks) * rep for blocks, rep in self.segments)

    @property
    def is_encoder_decoder(self) -> bool:
        return bool(self.encoder_segments)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline bookkeeping)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd, hq, hkv = self.hd, self.num_heads, self.num_kv_heads
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d

        def attn_params():
            return d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 2 * d  # qkvo + norms

        def mla_params():
            qr, kvr = self.q_lora_rank, self.kv_lora_rank
            nope, rope, vd = self.qk_nope_head_dim, self.qk_rope_head_dim, self.v_head_dim
            p = d * qr + qr * hq * (nope + rope)            # q path
            p += d * (kvr + rope) + kvr * hq * (nope + vd)  # kv path
            p += hq * vd * d + 2 * d + qr + kvr             # o + norms
            return p

        def ffn_params():
            return d * 2 * ff + ff * d + d

        def moe_params():
            e = self.num_experts
            return d * e + e * (d * 2 * ff + ff * d) + d

        def mamba_params():
            di = d * self.expand
            return d * (2 * di + 2 * self.ssm_state + self.num_heads) + di * d + 3 * di + d

        def xlstm_params(kind):
            di = d * self.expand
            if kind == "mlstm":
                return d * 2 * di + di * (3 * di // 1) // 1 + di * d + d  # approx
            return 4 * (d * d + d * d) + d * 2 * (4 * d // 3) + d  # approx

        per_block = {
            "full": attn_params() + ffn_params(),
            "swa": attn_params() + ffn_params(),
            "enc": attn_params() + ffn_params(),
            "dec": 2 * attn_params() + ffn_params(),
            "mla": mla_params() + ffn_params(),
            "full_moe": attn_params() + moe_params(),
            "mamba2": mamba_params(),
            "mlstm": xlstm_params("mlstm"),
            "slstm": xlstm_params("slstm"),
            "attn_shared": 0,  # counted once below
        }
        shared_sites = 0
        for blocks, rep in self.segments + self.encoder_segments:
            for b in blocks:
                n += per_block[b] * rep
                if b == "attn_shared":
                    shared_sites += rep
        if shared_sites:
            n += attn_params() + ffn_params()  # one shared copy
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k of E experts)."""
        if not self.num_experts:
            return self.param_count()
        d, ff, e, k = self.d_model, self.d_ff, self.num_experts, self.num_experts_per_tok
        inactive_per_moe = (e - k) * (d * 2 * ff + ff * d)
        moe_blocks = sum(
            sum(1 for b in blocks if b == "full_moe") * rep for blocks, rep in self.segments
        )
        return self.param_count() - moe_blocks * inactive_per_moe


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = (
    ShapeConfig("train_4k", "train", 4_096, 256),
    ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    ShapeConfig("decode_32k", "decode", 32_768, 128),
    ShapeConfig("long_500k", "decode", 524_288, 1),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
