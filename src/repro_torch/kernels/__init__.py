"""Hand-written CUDA kernels of the port, each beside its plain PyTorch twin.

- envstep/ : fused multi-step environment kernels (megastep) behind the pool
- raster/  : the software rasteriser that renders capsule scenes to frames
- attention/ : flash GQA attention for the LM stack's prefill
- build.py : nvcc build of csrc/*.cu, loaded with ctypes
"""
