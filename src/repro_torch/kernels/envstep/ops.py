"""Public megastep API: backend dispatch + the wrapper-stack adapter
(port of `repro.kernels.envstep.ops`).

`env_megastep` is the row-level op over the state rows and the lanes'
auto-reset keys: "cuda" launches the kernel, which splits each lane's key
every step and runs the env's reset where an episode ends; "torch" runs its
plain twin, `fresh_rows` (the same `split` + `reset` sequence
`AutoReset.step` makes every step, precomputed for the K steps) and then
`megastep_ref`; "auto" picks the kernel for CUDA tensors and the plain twin
for CPU tensors. Nothing falls back: a CUDA tensor given to "cuda" or
"auto" launches the kernel or raises, also where the kernel's compiled
body does not fit the instance (`FusedSpec.kernel_mismatch`).

`fused_step` is what `Env.fused_step` and the pool call. It takes the
batched `AutoResetState` that `Vec(AutoReset(env))` carries, flattens the
state to rows, runs the megastep with the state's keys (so the threefry
stream matches the per-step path bit for bit) and rebuilds the state.
Which parts of the stack fuse is read off the declared pipeline (`_plan`).

Pixel stacks (`FrameStack(ObsToPixels(core))`, `ObsToPixels(core)`, the
arcade ids) fuse too when the core's obs rows are its state rows
(`FusedSpec.obs_is_state`): the kernel advances the game logic for the
whole K-step chunk, then the chunk's frames are rasterised outside it, in
two batched launches over the K·B stepped scenes (`terminal_obs` rows) and
the K·B post-reset scenes (`obs` rows, the fresh state's where a lane
reset), and a K-step select loop rebuilds the frame stack. That renders
what the per-step path renders: one stepped and one fresh frame per lane
and step.

`fused_step(active=)` is the async pool's masked step: the megastep still
runs every lane, then `_mask_inactive` selects, per lane, the old state
(auto-reset key included) and zero outputs where the lane is inactive.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils._pytree import tree_map

from repro_torch import random as R
from repro_torch.core import pipeline as P
from repro_torch.kernels.envstep.megastep import megastep_cuda
from repro_torch.kernels.envstep.ref import megastep_ref
from repro_torch.kernels.envstep.specs import lookup

BACKENDS = ("auto", "cuda", "torch")


def env_megastep(spec, state, keys, actions, *, core,
                 max_steps: Optional[int] = None, backend: str = "auto"):
    """Row-level K-step fused op with backend dispatch (see the module doc).

    `spec` is the env's `FusedSpec`: its `kernel_id` picks the CUDA body,
    its `step_rows` drives the plain version. state (S', B) and actions
    (K, B) float32, keys (B, 2) the lanes' auto-reset keys. `core` is the
    `TimeLimit(base)` or base env of the rows, whose `reset` the plain
    branch runs. Returns (new_state (S', B), final_keys (B, 2), obs,
    terminal_obs (K, O, B), reward, done, truncated (K, B)).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "cuda" or (backend == "auto" and state.is_cuda):
        if spec.kernel_mismatch is not None:
            raise NotImplementedError(spec.kernel_mismatch)
        return megastep_cuda(spec.kernel_id, state, keys, actions,
                             max_steps=max_steps)
    final_keys, fresh, fresh_obs = fresh_rows(core, keys, actions.shape[0])
    new_state, *out = megastep_ref(spec.step_rows, state, actions, fresh,
                                   fresh_obs, max_steps=max_steps)
    return (new_state, final_keys, *out)


def _plan(env):
    """Read the fusion plan off the stack's declared pipeline.

    Accepts the one shape the kernel models, `[TimeLimit] [ObsToPixels
    [FrameStack]]` over a base env. Returns (core, num_stack, pixels):
    `core` is the TimeLimit(base) or bare-base sub-stack that `lookup`
    resolves, or (None, None, False) for anything else (opaque wrappers,
    FrameStack over non-pixel observations, other orders).
    """
    core, transforms = P.declared_pipeline(env)
    if core is None:
        return None, None, False
    stack = list(transforms)  # innermost-first; env is the outermost wrapper
    core, num_stack, pixels = env, None, False
    if stack and stack[-1].fusion == P.FUSION_FRAME_STACK:
        num_stack = stack.pop().num_frames
        core = core.env
    if stack and stack[-1].fusion == P.FUSION_PIXELS:
        pixels = True
        stack.pop()
        core = core.env
    elif num_stack is not None:
        return None, None, False
    if stack and not (len(stack) == 1
                      and stack[0].fusion == P.FUSION_TIME_LIMIT):
        return None, None, False
    return core, num_stack, pixels


def _pixel_fusable(spec, core) -> bool:
    """A pixel stack fuses when the core's obs rows are its state rows and
    the base env has a `scene()` to render them from."""
    return bool(spec.obs_is_state) and hasattr(core.unwrapped, "scene")


def _resolve(env):
    """(core, spec, max_steps, num_stack, pixels) of a fusable stack, or
    None."""
    core, num_stack, pixels = _plan(env)
    found = lookup(core) if core is not None else None
    if found is None or (pixels and not _pixel_fusable(found[0], core)):
        return None
    return (core,) + found + (num_stack, pixels)


def supports(env) -> bool:
    """True if `env` (base, TimeLimit(base), or a pixel stack over them)
    has a fused path."""
    return _resolve(env) is not None


def kernel_mismatch(env) -> Optional[str]:
    """Why the CUDA megastep's compiled body does not fit the fusable stack
    `env` (`FusedSpec.kernel_mismatch`), or None."""
    found = _resolve(env)
    return None if found is None else found[1].kernel_mismatch


def state_rows(spec, max_steps, wrapped):
    """A (TimeLimit-wrapped) state as megastep rows (..., S', B); the step
    counter is the last row when there is a TimeLimit."""
    if max_steps is None:
        return spec.flatten(wrapped)
    return torch.cat([spec.flatten(wrapped.inner),
                      wrapped.t.to(torch.float32).unsqueeze(-2)], -2)


def fresh_rows(env, keys: torch.Tensor, num_steps: int):
    """The auto-reset key chain and fresh reset rows for `num_steps` steps:
    the plain branch of `env_megastep`, and the oracle of the kernel's
    in-kernel resets.

    Per step, `split(key)` gives the next chain key and a reset key, as in
    `AutoReset.step`. The chain is sequential; the K resets are one batched
    `reset` over (K, B) keys. For a pixel stack the core sub-stack is reset
    (the pixel wrappers pass the key through untouched), and the fresh
    frames are rendered later from the obs rows. Returns (final_keys
    (B, 2), fresh_rows (K, S', B), fresh_obs_rows (K, O, B)), the rows
    contiguous float32, as the megastep takes them.
    """
    fresh_rows.calls += 1
    env, spec, max_steps = _resolve(env)[:3]
    reset_keys = []
    for _ in range(num_steps):
        pair = R.split(keys)
        keys = pair[..., 0, :]
        reset_keys.append(pair[..., 1, :])
    fresh_states, fresh_obs = env.reset(torch.stack(reset_keys))
    return (keys, state_rows(spec, max_steps, fresh_states).contiguous(),
            fresh_obs.transpose(-1, -2).to(torch.float32).contiguous())


#: calls since the count was last set to 0: chip_smoke.py shows that no
#: chunk of the CUDA path makes one
fresh_rows.calls = 0


def _render_obs_rows(core, spec, obs_rows, backend):
    """(K, O, B) obs rows -> (K, B, H, W) frames, one batched raster call.

    Valid because `spec.obs_is_state`: the obs rows are state rows, so each
    step's scene is rebuilt on the device from the kernel's obs output.
    """
    from repro_torch.kernels.raster import render_scene

    base = core.unwrapped
    return render_scene(*base.scene(spec.unflatten(obs_rows)),
                        *base.frame_shape, backend=backend)


def _stack_frames(frames, pre, post, done):
    """The frame-stack ring over K steps, as K `FrameStack.step`s under
    `AutoReset` give it: frames (B, N, H, W) most recent last, pre and post
    (K, B, H, W) the frames of the terminal_obs and obs rows (post is the
    fresh frame where a lane reset), done (K, B). Returns (obs,
    terminal_obs) (K, B, N, H, W)."""
    k = pre.shape[0]
    tobs = torch.empty((k,) + tuple(frames.shape), dtype=frames.dtype,
                       device=frames.device)
    obs = torch.empty_like(tobs)
    for t in range(k):
        tobs[t, :, :-1] = frames[:, 1:]
        tobs[t, :, -1] = pre[t]
        torch.where(done[t, :, None, None, None], post[t, :, None], tobs[t],
                    out=obs[t])
        frames = obs[t]
    return obs, tobs


def keep_idle_state(old, new, active):
    """Lanes where `active` (B,) is False keep their `old` rows: a select
    over every (B, ...) leaf of two like trees, the auto-reset key
    included, which the kernel returned advanced. The kernel still
    computes every lane; this select is what keeps an idle session's
    stream unperturbed."""
    def lane(n, o):
        act = active.to(device=n.device, dtype=torch.bool)
        return torch.where(act.reshape(act.shape + (1,) * (n.dim() - 1)), n, o)

    return tree_map(lane, new, old)


def _mask_inactive(old_state, new_state, ts, active):
    """Masked-active lane gating (the JAX package's `ops._mask_inactive`):
    lanes where `active` is False keep their pre-chunk state
    (`keep_idle_state`) and report zero obs, reward, info and done=False.
    """
    from repro_torch.core.env import Timestep

    act = active.to(device=ts.reward.device, dtype=torch.bool)

    def out(n):      # per-step output leaves: (K, B, ...)
        m = act.reshape((1,) + act.shape + (1,) * (n.dim() - 2))
        return torch.where(m, n, n.new_zeros(()))

    sel_state = keep_idle_state(old_state, new_state, act)
    info = {k: out(v) for k, v in ts.info.items()}
    return sel_state, Timestep(state=sel_state, obs=out(ts.obs),
                               reward=out(ts.reward), done=out(ts.done),
                               info=info)


def fused_step(env, state, actions, num_steps: Optional[int] = None, *,
               backend: str = "auto", active=None):
    """Advance a batched `AutoReset(env)` state by K fused steps.

    env     : the single-env stack the pool holds, `TimeLimit(base)` or
              base, optionally under `ObsToPixels` or
              `FrameStack(ObsToPixels(...))` (the arcade pixel pipeline).
    state   : `AutoResetState` with batched (B, ...) leaves.
    actions : (K, B) (discrete) or (K, B, 1) (continuous) action block.
    active  : optional (B,) bool lane mask (the async pool's masked
              step): lanes where it is False keep their state and key and
              report zero obs, reward, info and done=False. None steps
              every lane.

    Returns `(new_state, ts)`: `ts` is a `Timestep` whose obs / reward /
    done / info leaves carry a leading (K, ...) step axis, as K iterated
    `AutoReset(env).step` calls would give. `info` has `terminal_obs` and,
    with a TimeLimit, `truncated`.
    """
    from repro_torch.core.env import Timestep
    from repro_torch.core.wrappers import (AutoResetState, FrameStackState,
                                           TimeLimitState)

    found = _resolve(env)
    if found is None:
        raise NotImplementedError(
            f"no fused megastep spec for {env!r}; supported: CartPole, "
            "MountainCar, Pendulum, Acrobot, LightsOut, Pong, Breakout, "
            "FrozenLake, CliffWalk, Snake, Maze, bare or under one "
            "TimeLimit, the arcade games also under ObsToPixels or "
            "FrameStack(ObsToPixels)")
    core, spec, max_steps, num_stack, pixels = found

    acts = actions
    if acts.dim() == 3 and acts.shape[-1] == 1:
        acts = acts[..., 0]
    if acts.dim() != 2:
        raise ValueError(f"actions must be (K, B[, 1]); got {tuple(actions.shape)}")
    k = acts.shape[0]
    if num_steps is not None and num_steps != k:
        raise ValueError(f"num_steps={num_steps} != actions.shape[0]={k}")

    core_state = state.inner.inner if num_stack is not None else state.inner
    rows = state_rows(spec, max_steps, core_state).contiguous()
    new_rows, final_keys, obs, tobs, reward, done, trunc = env_megastep(
        spec, rows, state.key.contiguous(),
        acts.to(torch.float32).contiguous(), core=core, max_steps=max_steps,
        backend=backend)

    inner = spec.unflatten(new_rows[:spec.state_size])
    done = done.to(torch.bool)
    info = {}
    if max_steps is not None:
        inner = TimeLimitState(inner, new_rows[spec.state_size].to(torch.int32))
        info["truncated"] = trunc.to(torch.bool)
    if not pixels:
        # The kernel computes in float32 rows; integer observations (the
        # grid suite's cell codes) get their dtype back, exactly.
        odt = core.observation_space.dtype
        info["terminal_obs"] = tobs.transpose(-1, -2).to(odt)
        new_state = AutoResetState(inner, final_keys)
        out = new_state, Timestep(state=new_state,
                                  obs=obs.transpose(-1, -2).to(odt),
                                  reward=reward, done=done, info=info)
        return out if active is None else _mask_inactive(state, *out,
                                                         active=active)

    # Pixel pipeline: the chunk's stepped (pre-reset) and post-reset frames
    # in two batched raster launches (the obs rows are the fresh state's
    # where a lane reset), then, under a FrameStack, the ring, step by step.
    pre = _render_obs_rows(core, spec, tobs, backend)        # (K, B, H, W)
    post = _render_obs_rows(core, spec, obs, backend)
    if num_stack is None:
        obs_px, tobs_px = post, pre
    else:
        obs_px, tobs_px = _stack_frames(state.inner.frames, pre, post, done)
        # a copy, so the state does not hold the chunk's obs alive
        inner = FrameStackState(inner, obs_px[-1].clone())
    info["terminal_obs"] = tobs_px
    new_state = AutoResetState(inner, final_keys)
    out = new_state, Timestep(state=new_state, obs=obs_px, reward=reward,
                              done=done, info=info)
    return out if active is None else _mask_inactive(state, *out,
                                                     active=active)


__all__ = ["BACKENDS", "env_megastep", "fresh_rows", "fused_step",
           "keep_idle_state", "kernel_mismatch", "state_rows", "supports"]
