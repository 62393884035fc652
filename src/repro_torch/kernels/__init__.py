"""Hand-written CUDA kernels of the port, each beside its plain PyTorch twin.

- envstep/ : fused multi-step environment kernels (megastep) behind the pool
- raster/  : the software rasteriser that renders capsule scenes to frames
- attention/ : flash GQA attention for the LM stack's prefill
- build.py : nvcc build of csrc/*.cu, loaded with ctypes
"""


def launch_counters():
    """{kernel name: its wrapper}. Each wrapper adds one to its `.launches`
    where it launches its kernel; a CUDA graph that replays captured
    launches adds them per replay (train/fused.py)."""
    from repro_torch.kernels.attention import flash_attention_cuda
    from repro_torch.kernels.envstep import megastep_cuda
    from repro_torch.kernels.raster import rasterize_cuda

    return {"megastep": megastep_cuda, "raster": rasterize_cuda,
            "flash": flash_attention_cuda}
