"""Per-env fused-step specs: row-major dynamics for the megastep kernel
(port of `repro.kernels.envstep.specs`).

A `FusedSpec` describes one base env in row-major form: the batched state
is one `(S, B)` float32 matrix (a row per state component, the batch on the
minor axis) and `step_rows` advances all B lanes. The layout comes from
`derive_layout`, read off a 1-lane CPU reset. The envs of this package are
batch-native, so `step_rows` is the env's own `step` seen through that
layout; the JAX package writes it out by hand only because its envs step a
single lane. `kernel_id` picks the same dynamics' body in csrc/megastep.cu.

`kernel_mismatch` names the instance's parameters that differ from those
the CUDA body compiles in (`megastep.Body.params`: the grid sizes and
LightsOut's scramble presses), or is None. Such an instance still fuses
through the plain version, which steps the instance's own geometry, but the
kernel path is not offered: `make_vec(backend="auto")` on the card picks
"vmap", and the "cuda" backend raises.

`obs_is_state` says that the observation is the flattened state, declared
per env as in the JAX package; it lets the pixel pipeline render every
step's frame from the kernel's obs rows (ops.py::fused_step). The grid
suite observes cell codes, not its state, so its `-px` ids run the vmap
backend, as in the JAX package. Integer state (boards, cell indices, ages)
rides in the float32 rows; its values are small, so the round trip is
exact.

`spec_for(core_env)` derives the spec of a supported base env; `lookup(env)`
also accepts one declared `TimeLimit` over it and returns
`(spec, max_steps)`, else None.
"""
from __future__ import annotations

import math
import weakref
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import random as R
from repro_torch.kernels.envstep.megastep import BODIES


class FusedSpec(NamedTuple):
    """Row-major dynamics of one base env (state components x batch lanes)."""

    name: str
    state_size: int     # S: rows in the flattened base state
    obs_size: int       # O: rows in the observation
    # flatten: state with (..., B) leaves -> (..., S, B) float32 rows
    flatten: Callable[[Any], torch.Tensor]
    # unflatten: (S, B) rows -> state with (B,) leaves (inverse of flatten)
    unflatten: Callable[[torch.Tensor], Any]
    # step_rows: (rows (S, B), action (B,) float32)
    #   -> (new_rows (S, B), obs (O, B), reward (B,), done (B,) float32)
    step_rows: Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, ...]]
    kernel_id: int      # the body's index in csrc/megastep.cu
    # obs rows == state rows (obs = flattened base state): pixel stacks over
    # an env with a `scene()` then fuse too
    obs_is_state: bool = False
    # why the CUDA body does not fit this instance, or None
    kernel_mismatch: Optional[str] = None


def derive_layout(env, field_order: Optional[Tuple[str, ...]] = None):
    """Read a 1-lane CPU reset: (state_size, obs_size, flatten, unflatten).

    The state NamedTuple's fields, in declaration order or in `field_order`,
    become consecutive row blocks of `prod(field_shape)` rows; the batch
    stays on the minor axis. `flatten` and `unflatten` accept leading axes
    before the batch axis (the (K, B) fresh-reset stacks and per-step obs
    rows of `ops.fused_step`).
    """
    state, obs = env.reset(R.PRNGKey(0, device="cpu")[None])
    cls = type(state)
    fields = tuple(state._fields) if field_order is None else tuple(field_order)
    if sorted(fields) != sorted(state._fields):
        raise ValueError(f"field_order {fields} != state fields "
                         f"{state._fields}")
    shapes = {f: tuple(getattr(state, f).shape[1:]) for f in fields}
    dtypes = {f: getattr(state, f).dtype for f in fields}
    sizes = {f: math.prod(shapes[f]) for f in fields}

    def flatten(s) -> torch.Tensor:
        rows = []
        for f in fields:
            leaf = getattr(s, f)
            lead = leaf.shape[: leaf.dim() - len(shapes[f])]
            rows.append(leaf.reshape(lead + (sizes[f],)).transpose(-1, -2))
        return torch.cat(rows, -2).to(torch.float32)

    def unflatten(rows: torch.Tensor):
        parts, offset = {}, 0
        for f in fields:
            block = rows[..., offset:offset + sizes[f], :].transpose(-1, -2)
            offset += sizes[f]
            parts[f] = block.reshape(block.shape[:-1] + shapes[f]).to(dtypes[f])
        return cls(**parts)

    return sum(sizes.values()), obs.shape[-1], flatten, unflatten


def _rows_of(env, flatten, unflatten):
    def step_rows(rows, act):
        ts = env.step(unflatten(rows), act)
        return (flatten(ts.state), ts.obs.transpose(-1, -2).to(torch.float32),
                ts.reward, ts.done.to(torch.float32))
    return step_rows


class Fusion(NamedTuple):
    """What a base env class with a kernel body declares besides its body."""

    obs_is_state: bool
    field_order: Optional[Tuple[str, ...]] = None


def _fused_classes():
    """Base env classes with a kernel body -> their `Fusion`."""
    from repro_torch.envs.arcade import Breakout, Pong
    from repro_torch.envs.classic import Acrobot, CartPole, MountainCar, Pendulum
    from repro_torch.envs.grid import CliffWalk, FrozenLake, Maze, Snake
    from repro_torch.envs.puzzle import LightsOut

    return {CartPole: Fusion(True), MountainCar: Fusion(True),
            Pendulum: Fusion(False), Acrobot: Fusion(False),
            Pong: Fusion(True), Breakout: Fusion(True),
            LightsOut: Fusion(False), FrozenLake: Fusion(False),
            CliffWalk: Fusion(False), Maze: Fusion(False),
            # the kernel body reads the scalars (head, food, length, eaten)
            # first; the state NamedTuple declares `ages` first
            Snake: Fusion(False, ("head", "food", "length", "eaten", "ages",
                                  "prio"))}


#: per-instance memo: pools look a spec up on every fused chunk
_SPEC_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def spec_for(env) -> Optional[FusedSpec]:
    """Derive the `FusedSpec` for a supported *base* env, else None."""
    if env in _SPEC_CACHE:
        return _SPEC_CACHE[env]
    spec = None
    fusion = _fused_classes().get(type(env))
    if fusion is not None:
        name = type(env).__name__
        body = BODIES[name]
        state_size, obs_size, flatten, unflatten = derive_layout(
            env, fusion.field_order)
        compiled = dict(body.params)
        given = {p: getattr(env, p) for p in compiled}
        mismatch = None
        if given != compiled:
            mismatch = (f"{name} with {given}: the CUDA megastep body is "
                        f"compiled for {compiled} only")
        elif (state_size, obs_size) != (body.state_size, body.obs_size):
            raise RuntimeError(f"{name}: layout {(state_size, obs_size)} != "
                               f"kernel body {body}")
        spec = FusedSpec(name, state_size, obs_size, flatten, unflatten,
                         _rows_of(env, flatten, unflatten), body.kernel_id,
                         fusion.obs_is_state, mismatch)
    _SPEC_CACHE[env] = spec
    return spec


def lookup(env) -> Optional[Tuple[FusedSpec, Optional[int]]]:
    """(spec, max_steps) for `env` = base or TimeLimit(base), else None."""
    from repro_torch.core.pipeline import TimeLimit, declared_pipeline

    core, transforms = declared_pipeline(env)
    if core is None:
        return None
    max_steps = None
    if transforms:
        if len(transforms) != 1 or not isinstance(transforms[0], TimeLimit):
            return None
        max_steps = transforms[0].max_steps
    spec = spec_for(core)
    if spec is None:
        return None
    return spec, max_steps


__all__ = ["FusedSpec", "derive_layout", "lookup", "spec_for"]
