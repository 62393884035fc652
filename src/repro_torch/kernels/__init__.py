"""Hand-written CUDA kernels of the port, each beside its plain PyTorch twin.

- envstep/ : fused multi-step environment kernels (megastep) behind the pool
- build.py : nvcc build of csrc/*.cu, loaded with ctypes
"""
