"""Architecture registry: full configs and reduced smoke configs (port of
`repro.configs.registry`).

Every assigned arch ships:
  - `full()`    : the exact published configuration.
  - `reduced()` : same family/pattern, tiny dims, for the CPU tests.

`get_config` works for every arch. The port builds models of the block
kinds "full" and "swa" so far; `models/lm.py::init_params` names the
ROADMAP item for the others. `input_specs` (ShapeDtypeStructs for the JAX
dry run) has no counterpart here yet (ROADMAP A14).

Skips: long_500k for pure full-attention archs.
"""
from __future__ import annotations

import importlib
from typing import Optional

from repro_torch.configs.base import ModelConfig

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


__all__ = ["ARCH_IDS", "LONG_CONTEXT_OK", "cell_supported", "get_config"]
