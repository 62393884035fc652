"""Core env protocol, spaces, wrappers, pipelines and registry (PyTorch)."""
from repro_torch.core.env import Env, Timestep, supports_fused_step
from repro_torch.core.pipeline import Transform, build_pipeline, declared_pipeline
from repro_torch.core.registry import (EnvSpec, make, register_family,
                                       register_spec, registered, spec)
from repro_torch.core.spaces import (Box, Discrete, MultiDiscrete, Space,
                                     sample_batch)
from repro_torch.core.wrappers import (AutoReset, FrameStack, ObsToPixels,
                                       TimeLimit, Vec, Wrapper)

__all__ = [
    "AutoReset", "Box", "Discrete", "Env", "EnvSpec", "FrameStack",
    "MultiDiscrete", "ObsToPixels", "Space", "TimeLimit",
    "Timestep", "Transform", "Vec", "Wrapper", "build_pipeline",
    "declared_pipeline", "make", "register_family", "register_spec",
    "registered", "sample_batch", "spec", "supports_fused_step",
]
