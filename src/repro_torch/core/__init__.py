"""Core env protocol, spaces, wrappers, pipelines, registry, the Gym shim
and the runners (PyTorch)."""
from repro_torch.core import pipeline
from repro_torch.core.env import Env, Timestep, supports_fused_step
from repro_torch.core.pipeline import Transform, build_pipeline, declared_pipeline
from repro_torch.core.registry import (EnvSpec, make, make_compat, register,
                                       register_family, register_spec,
                                       registered, spec, spec_of, specs)
from repro_torch.core.runner import (PythonRunner, Trajectory, episode_return,
                                     rollout, rollout_random)
from repro_torch.core.spaces import (Box, Discrete, MultiDiscrete, Space,
                                     sample_batch)
from repro_torch.core.wrappers import (AutoReset, FlattenObs, FrameStack,
                                       ObsToPixels, RewardScale, TimeLimit,
                                       Vec, Wrapper)

#: the JAX package's `repro.core` surface; `sample_batch` and
#: `supports_fused_step` stay importable from here, as they were
__all__ = [
    "Env", "EnvSpec", "Timestep", "Transform", "build_pipeline",
    "declared_pipeline", "make", "make_compat", "pipeline", "register",
    "register_family", "register_spec", "registered", "spec", "spec_of",
    "specs",
    "PythonRunner", "Trajectory", "episode_return", "rollout", "rollout_random",
    "Box", "Discrete", "MultiDiscrete", "Space",
    "AutoReset", "FlattenObs", "FrameStack", "ObsToPixels", "RewardScale",
    "TimeLimit", "Vec", "Wrapper",
]
