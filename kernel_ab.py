#!/usr/bin/env python3
"""Time the package's megastep, raster and flash kernels beside other
builds of the same C interface, in one process on one GPU.

    python3 kernel_ab.py DIR [DIR ...]

from the repository root, on a machine with a CUDA card and the CUDA
toolkit. Each DIR holds a megastep.cu, a raster.cu, a flash.cu or several,
with the C entry points of src/repro_torch/csrc's: an earlier commit's
sources (`git archive <commit> src/repro_torch/csrc`, where the interface
is the same: flash.cu's entry point takes a value head dim `Dv` after `D`
since MLA's instantiation, so an older flash.cu does not bind), or a copy
of a source with other constants. They are built in
parallel with the package's nvcc flags into the package's _build/ab/, and
each build runs through the package's own wrapper, whose library is
pointed at the build for the while: every launch is checked as the
package's are. Only the kernels some DIR holds are timed.

Megastep. For each fused id of chip_smoke.py's phase main, at its B and K:
a chunk of its main path after WARM_CHUNKS chunks from the pool's reset
(episodes under way, so lanes reset at their steady rate); for the grid
and puzzle bodies also the reset-heavy case of phase kernel (a TimeLimit
of 3 over K = 32). Every build's outputs must equal the package kernel's
bit for bit (chip_smoke.py holds that one against its plain twin).

Raster. The scenes are those that chip_smoke.py's phase main draws. For
each of its raster families (the four classic render rollouts, Pong-v0,
Breakout-v0, Maze-px, FrozenLake-px and the Maze-v0 render rollout), a
rollout of a few steps at that family's batch and unroll records the
rasteriser's launches. Every build is held bit for bit against
rasterize_ref on every recorded launch, then timed on each family's
launches after the reset's by CUDA events. A family's mean time per launch
times its launch count in phase main (the reset's counted as one of the
others), summed over the families, is the raster's device time over phase
main's launches: the number the tile shape is chosen on.

Flash. At the Yi-6B shape (bf16, Lq 2,048 over a 4,096-slot cache,
causal), each build, the package's kernel and
scaled_dot_product_attention, against attention_ref.

The package's build and the others are timed in the order given, then
again in reverse. One JSON line per case, with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import sys
from pathlib import Path

import chip_smoke as C

RUNS = 10
#: chunks each megastep pool runs before the chunk that is timed
WARM_CHUNKS = 8
KERNELS = ("megastep", "raster", "flash")
#: the raster families of chip_smoke.py's phase main: (id, B, unroll,
#: render, steps recorded, raster launches in phase main)
FAMILIES = (
    *((i, C.B_MAIN, C.K, True, 4, C.RENDER_STEPS + 1) for i in C.IDS),
    *((i, C.B_PIXEL, C.K_PIXEL, False, 2 * C.K_PIXEL,
       2 * (C.STEPS // C.K_PIXEL) + 1) for i in C.PIXEL_IDS),
    *((i, C.B_PIXEL, 1, False, 4, 2 * C.GRID_PX_STEPS + 1)
      for i in C.GRID_PX_IDS),
    (C.GRID_RENDER_ID, C.B_MAIN, C.K, True, 4, C.GRID_RENDER_STEPS + 1),
)


@contextlib.contextmanager
def routed(module, lib):
    """The package wrapper of `module` launches `lib`'s kernel (None: the
    package's own) while the block runs."""
    original = module._library
    if lib is not None:
        fn = module._bind(lib)
        module._library = lambda: fn
    try:
        yield
    finally:
        module._library = original


def build_dirs(dirs):
    """{(dir index, kernel name): ctypes.CDLL} of every source the dirs
    hold, built all at once."""
    from repro_torch.kernels import build

    jobs = {name: (build.library_path(name), build.CSRC / f"{name}.cu")
            for name in KERNELS}        # the package's own
    for i, d in enumerate(dirs):
        for name in KERNELS:
            if (d / f"{name}.cu").exists():
                jobs[(i, name)] = (build.BUILD_DIR / "ab" / f"{i}-{name}.so",
                                   d / f"{name}.cu")
    build.compile_all({out: src for out, src in jobs.values()
                       if not out.exists() or out.parent.name == "ab"})
    return {key: ctypes.CDLL(str(out)) for key, (out, _) in jobs.items()
            if isinstance(key, tuple)}


def record_launches(env_id, b, unroll, render, steps, device):
    """[(segs, intens, h, w)] of every raster launch of a `steps`-step
    rollout of env_id."""
    import repro_torch
    from repro_torch import random as R
    from repro_torch.kernels.raster import ops

    original, seen = ops.rasterize_cuda, []

    def spy(segs, intens, h, w):
        seen.append((segs.clone(), intens.clone(), h, w))
        return original(segs, intens, h, w)

    pool = repro_torch.make_vec(env_id, b, unroll=unroll, device=device)
    ops.rasterize_cuda = spy
    try:
        pool.rollout(steps, R.PRNGKey(0, device), render=render)
    finally:
        ops.rasterize_cuda = original
    return seen


def steady_chunk(torch, env_id, device):
    """(pool, chunk operands) of env_id's main-path pool, WARM_CHUNKS
    chunks after its reset."""
    import repro_torch
    from repro_torch import random as R
    from repro_torch.core.spaces import sample_batch

    pixel = env_id in C.PIXEL_IDS
    b, k = (C.B_PIXEL, C.K_PIXEL) if pixel else (C.B_MAIN, C.K)
    pool = repro_torch.make_vec(env_id, b, unroll=k, device=device)
    h, key = pool.xla(), R.PRNGKey(0, device)
    ps = h.init(key)
    for i in range(WARM_CHUNKS):
        steps = torch.arange(i * k + 1, (i + 1) * k + 1, device=device)
        ps, _ = h.step_many(ps, sample_batch(pool.action_space,
                                             R.fold_in(key, steps), b))
    return pool, C.chunk_ops(torch, pool, ps.env_state, k,
                             R.fold_in(key, 7), device)


def megastep_ab(torch, device, builds, smi):
    from repro_torch.kernels.envstep import BODIES, megastep, megastep_cuda

    names = list(builds)
    for env_id in C.IDS + C.PIXEL_IDS + C.GRID_IDS:
        pool, (core, spec, max_steps, ops) = steady_chunk(torch, env_id,
                                                          device)
        cases = [(f"{env_id} main path, chunk {WARM_CHUNKS + 1}", ops,
                  max_steps)]
        if spec.name in C.GRID:
            cases.append((f"{spec.name} reset-heavy", C.grid_kernel_inputs(
                torch, spec.name, C.HEAVY_MAX_STEPS, C.B_MAIN, C.K, 0,
                device), C.HEAVY_MAX_STEPS))
        for what, args, steps in cases:
            call = lambda: megastep_cuda(BODIES[spec.name].kernel_id, *args,
                                         max_steps=steps)
            want = call()
            for name, lib in builds.items():
                with routed(megastep, lib):
                    got = call()
                for n, g, w in zip(C.OUTPUTS, got, want):
                    if not torch.equal(g, w):
                        raise AssertionError(f"{name} on {what}: {n} differs "
                                             "from the package's kernel")
            ms = {n: [] for n in names}
            for order in (names, names[::-1]):
                for name in order:
                    with routed(megastep, builds[name]):
                        ms[name].append(C.event_ms(torch, call, RUNS * 2))
            C.emit({"case": f"megastep, {what}", "B": int(args[2].shape[1]),
                    "K": int(args[2].shape[0]), "max_steps": steps,
                    "resets": int(want[5].sum()), "ms": ms, "card": smi})
        del pool, ops, cases


def raster_ab(torch, device, builds, smi):
    from repro_torch.kernels.raster import raster, rasterize_cuda, rasterize_ref

    names = list(builds)
    total = {n: [0.0, 0.0] for n in names}
    for env_id, b, unroll, render, steps, launches in FAMILIES:
        calls = record_launches(env_id, b, unroll, render, steps,
                                device)
        for j, args in enumerate(calls):
            want = rasterize_ref(*args).view(torch.int32)
            for name, lib in builds.items():
                with routed(raster, lib):
                    got = rasterize_cuda(*args).view(torch.int32)
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} on {env_id} launch {j}: "
                                         f"{int((got != want).sum())} pixels "
                                         "differ from rasterize_ref")
            del want, got
        steady, ms = calls[1:], {n: [] for n in names}
        for order in (names, names[::-1]):
            for name in order:
                with routed(raster, builds[name]):
                    per_call = C.event_ms(
                        torch, lambda: [rasterize_cuda(*a) for a in steady],
                        RUNS, warmup=1) / len(steady)
                ms[name].append(per_call)
        for name in names:
            for k in (0, 1):
                total[name][k] += launches * ms[name][k]
        C.emit({"case": f"raster, {env_id} launches", "B": b,
                "unroll": unroll, "render": render,
                "frames": [int(a[1].shape[0]) for a in calls],
                "S": int(calls[0][1].shape[1]),
                "launches_in_phase_main": launches,
                "ms_per_launch": ms, "card": smi})
        del calls
    C.emit({"case": "raster, phase main's launches, summed",
            "launches": sum(f[-1] for f in FAMILIES), "ms": total,
            "card": smi, "clock": f"CUDA events over {RUNS} replays; each "
                                  "build timed in order, then in reverse"})


def flash_ab(torch, device, builds, smi):
    import torch.nn.functional as F

    from repro_torch.kernels.attention import (attention_ref, flash,
                                               flash_attention_cuda)

    q, k, v = C.attention_inputs(torch, C.YI_HEADS, 1, 2048, 4096,
                                 torch.bfloat16, 0, device)
    want = attention_ref(q, k, v)
    calls = {}
    for name, lib in builds.items():
        def call(lib=lib):
            with routed(flash, lib):
                return flash_attention_cuda(q, k, v)
        calls[name] = call
    calls["sdpa"] = lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)
    errs, times = {}, {}
    for name, call in calls.items():
        got = call()
        errs[name] = {
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "bits_differ": float((got.view(torch.int16)
                                  != want.view(torch.int16)).float().mean())}
    names = list(calls)
    for order in (names, names[::-1]):
        for name in order:
            times.setdefault(name, []).append(
                C.event_ms(torch, calls[name], RUNS))
    C.emit({"case": "flash bf16, Yi heads, Lq 2,048 over 4,096, causal",
            "ms": times, "against_attention_ref": errs, "card": smi,
            "clock": f"CUDA events over {RUNS} calls; in order, then in "
                     "reverse"})


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("dirs", type=Path, nargs="+",
                        help="directories of megastep.cu, raster.cu and/or "
                             "flash.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab.py needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _, smi = C.phase_device(torch)
    device = torch.device("cuda")
    libs = build_dirs(args.dirs)
    for kernel, run in (("megastep", megastep_ab), ("raster", raster_ab),
                        ("flash", flash_ab)):
        others = {str(args.dirs[i]): lib for (i, k), lib in libs.items()
                  if k == kernel}
        if others:
            run(torch, device, {"package": None, **others}, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
