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


#: while a list (analysis/cost.py::counting), each kernel dispatch appends
#: (kernel name, a thunk giving its wrapper's `cost` for the launch it makes
#: or the plain twin it runs); the thunk runs when the counting ends, so
#: no count syncs the step it counts
COST_LOG = None


def log_cost(name: str, thunk) -> None:
    if COST_LOG is not None:
        COST_LOG.append((name, thunk))


def plain(fn, *args, **kwargs):
    """`fn(*args, **kwargs)`, a kernel's plain twin. While counting, the
    counting dispatch modes are off for it: the kernel's `cost` stands for
    its work, as it does for the launch on the card."""
    if COST_LOG is None:
        return fn(*args, **kwargs)
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        return fn(*args, **kwargs)
