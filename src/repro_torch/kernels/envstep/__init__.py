"""Fused multi-step environment kernels (megastep), PyTorch + CUDA.

megastep.py (the CUDA kernel's wrapper, sources in csrc/megastep.cu),
ref.py (the plain PyTorch version), ops.py (backend dispatch and the
wrapper-stack adapter `fused_step`), specs.py (per-env row layout).
"""
from repro_torch.kernels.envstep.megastep import BODIES, megastep_cuda
from repro_torch.kernels.envstep.ops import (env_megastep, fresh_rows,
                                             fused_step, kernel_mismatch,
                                             supports)
from repro_torch.kernels.envstep.ref import fused_transition, megastep_ref
from repro_torch.kernels.envstep.specs import (FusedSpec, derive_layout,
                                               lookup, spec_for)

__all__ = [
    "BODIES", "FusedSpec", "derive_layout", "env_megastep", "fresh_rows",
    "fused_step", "fused_transition", "kernel_mismatch", "lookup",
    "megastep_cuda",
    "megastep_ref", "spec_for", "supports",
]
