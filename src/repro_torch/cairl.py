"""`from repro_torch import cairl; e = cairl.make("CartPole-v1")`: the
Listing 2 drop-in (port of `repro.cairl`).

`make` returns the stateful Gym-compatible shim (reset/step/render) on the
CUDA card unless given a `device`, matching the paper's migration story:
change one import line, keep the experiment code. For the fast paths use
`cairl.make_functional` + `cairl.rollout`, or `cairl.make_vec(id,
num_envs)`, the vector frontend over the pools. `cairl.spec(id)` exposes
the `EnvSpec` (transform pipeline, tags, time limit) behind each id.
"""
from repro_torch.core.registry import make_compat as make  # noqa: F401
from repro_torch.core.registry import make as make_functional  # noqa: F401
from repro_torch.core.registry import registered, spec, spec_of  # noqa: F401
from repro_torch.core.runner import rollout, rollout_random  # noqa: F401
from repro_torch.pool import (EnvPool, HostPool, ShardedEnvPool,  # noqa: F401
                              make_pool, make_vec)
