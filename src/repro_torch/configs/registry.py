"""Architecture registry: full configs and reduced smoke configs (port of
`repro.configs.registry`).

Every assigned arch ships:
  - `full()`    : the exact published configuration.
  - `reduced()` : same family/pattern, tiny dims, for the CPU tests.

`get_config` works for every arch. `input_specs(cfg, shape)` gives the
inputs of one (train | prefill | decode) step as tensors on the "meta"
device: shapes and dtypes, no memory (the dry run's stand-ins, as the JAX
package's ShapeDtypeStructs are).

Skips: long_500k for pure full-attention archs.
"""
from __future__ import annotations

import importlib
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, shape_by_name

ARCH_IDS = (
    "yi-6b",
    "minicpm3-4b",
    "h2o-danube-1.8b",
    "gemma3-27b",
    "xlstm-350m",
    "chameleon-34b",
    "zamba2-2.7b",
    "whisper-base",
    "olmoe-1b-7b",
    "granite-moe-1b-a400m",
)

_MODULES = {
    "yi-6b": "yi_6b",
    "minicpm3-4b": "minicpm3_4b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "gemma3-27b": "gemma3_27b",
    "xlstm-350m": "xlstm_350m",
    "chameleon-34b": "chameleon_34b",
    "zamba2-2.7b": "zamba2_2_7b",
    "whisper-base": "whisper_base",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
}

# long_500k requires sub-quadratic attention / bounded state.
LONG_CONTEXT_OK = {"xlstm-350m", "zamba2-2.7b", "h2o-danube-1.8b", "gemma3-27b"}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.reduced() if reduced else mod.full()


def cell_supported(arch: str, shape_name: str) -> Optional[str]:
    """None if the (arch, shape) cell runs; else a skip reason string."""
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_OK:
        return "pure full-attention arch: 500k-token decode is skipped (DESIGN.md §5)"
    return None


def input_specs(cfg: ModelConfig, shape: ShapeConfig | str,
                max_seq: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins for one step's model inputs (no memory)."""
    if isinstance(shape, str):
        shape = shape_by_name(shape)
    b, l = shape.global_batch, shape.seq_len
    meta = lambda dims, dtype: torch.empty(dims, dtype=dtype, device="meta")
    frames = ({"frames": meta((b, cfg.encoder_len, cfg.d_model),
                              torch.bfloat16)}
              if cfg.is_encoder_decoder else {})
    if shape.kind == "train":
        return {"tokens": meta((b, l), torch.int32),
                "labels": meta((b, l), torch.int32), **frames}
    if shape.kind == "prefill":
        return {"tokens": meta((b, l), torch.int32), **frames}
    if shape.kind == "decode":
        # one new token against a seq_len-deep cache
        return {"tokens": meta((b, 1), torch.int32)}
    raise ValueError(shape.kind)


__all__ = ["ARCH_IDS", "LONG_CONTEXT_OK", "cell_supported", "get_config",
           "input_specs"]
