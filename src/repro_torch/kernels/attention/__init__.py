"""Flash GQA attention, PyTorch + CUDA.

flash.py (the CUDA kernel's wrapper, sources in csrc/flash.cu), ref.py
(the plain PyTorch version), ops.py (backend dispatch).
"""
from repro_torch.kernels.attention.flash import flash_attention_cuda
from repro_torch.kernels.attention.ops import attention
from repro_torch.kernels.attention.ref import attention_ref

__all__ = ["attention", "attention_ref", "flash_attention_cuda"]
