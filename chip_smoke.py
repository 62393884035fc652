#!/usr/bin/env python3
"""Build and run the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

from the repository root, on a machine with a CUDA card and the CUDA
toolkit. It exits non-zero, printing no result, when there is no card or no
repository around it. Phases, each printing one JSON line with its seconds:

  device   the card (and nvidia-smi's name and power limit line)
  build    nvcc builds of csrc/megastep.cu, csrc/raster.cu and
           csrc/flash.cu, in parallel, with ptxas's register and spill
           report per kernel instantiation
  attention  the CUDA flash attention against its plain version
           (attention_ref) on the card, in bf16 (the tensor-core kernel)
           and f32 (the CUDA-core kernel), at Yi-6B's heads
           (32/4, D 128) and h2o-danube-1.8b's (32/8, D 80): a 2,048-token
           prompt over a 4,096-slot cache, a ragged 37-token prompt, a
           decode row at position 3,000, Danube's 4,096 window over 4,608
           tokens, non-causal 1,024², and B = 2; max error, the share of
           outputs whose bits differ, and at the main path's shape kernel,
           plain and SDPA times and the bound
  lm       the LM serving path: Yi-6B at full width and depth (random
           params from a seed) through ServeEngine(slots=8, max_seq=4096),
           16 requests of 128 to 2,048 prompt tokens and 64 greedy new
           tokens each, with the launch counts set to 0 just before and
           read just after (one flash launch per layer per prefill: 512);
           tokens/s, time to first token and stats(); prefill + decode
           against forward through the kernel; the kernel on the real q, k
           and v of layers 0 and 31 of a 2,048-token prefill. Then
           h2o-danube-1.8b at full width, 4 layers: a 4,608-token prefill
           through the ring path, the kernel on its layers' q, k and v, and
           16 per-slot decode steps (no kernel launch)
  kernel   the CUDA megastep, which splits each lane's key and runs the
           env's reset in-kernel, against its plain twin on the card (the
           key chain and resets of fresh_rows, then megastep_ref): the four
           classic bodies at K = 32, Pong and Breakout at K = 8 and the five
           grid and puzzle bodies (LightsOut, FrozenLake, CliffWalk, Maze,
           Snake) at K = 32 from states steered into their terminal cases,
           each with and without its TimeLimit, and every body reset-heavy
           (a TimeLimit of 3, K = 32), at B = 65,573 (a ragged last block);
           final keys, done and truncated exact, the grid bodies bit for
           bit; the resets per body (none fails)
  raster   the CUDA rasteriser against its plain version on the card, bit
           for bit in every case: Pong and Breakout scenes at the pixel
           path's 32,768 frames of 84×84, a ragged frame count and a
           non-square frame; 32,768 frames of each grid family's point
           capsules, LightsOut's and Multitask's scenes; kernel and plain
           times and the bound over the pixel-segment pairs of non-zero
           coverage (the all-pairs count beside it)
  main     paths, each with the launch counts set to 0 just before and read
           just after: make_vec(id, 65536, unroll=32).rollout(1024) for the
           four classic ids; make_vec(id, 4096, unroll=8).rollout(1024) for
           Pong-v0 and Breakout-v0 (megastep and raster);
           rollout(256, render=True) for the classic ids at B = 65,536;
           rollout(1024) at B = 65,536, K = 32 for the five grid and puzzle
           ids; Multitask-v0 on the vmap backend (no kernel) at B = 65,536
           for 256 steps; Maze-px and FrozenLake-px on the vmap backend at
           B = 4,096 for 128 steps (raster only); rollout(64, render=True)
           for Maze-v0 at B = 65,536. Then the fused rollouts again with
           host syncs made errors. No chunk calls fresh_rows (its count
           stays 0)
  render_check  both kernels against their plain versions at the render
           path's shapes: a K = 1 megastep at B = 65,536 per render id and
           the raster of the 65,536 frames its new state renders to
  parity   64-step rollouts, backend "cuda" against "torch", on the card,
           and a pixel chunk's frames
  golden   the 28 committed tests/golden traces, replayed on the card
  train    DQN through the port's learner (rl/dqn.py): the megastep against
           its plain twin at the learner's widths (B = 1, 2, 4; CartPole,
           FrozenLake, Pong; K = 1 and reset-heavy); the two committed
           training goldens (tests/golden/train_dqn_*.json) through
           train_compiled on the megastep, 64 launches each; Table I on
           CartPole-v1 (PAPER_TABLE_I, learn_start 100, B = 1) for 2,000
           steps, every step after the first with host syncs made errors:
           seconds, transitions/s, median ms a step by CUDA events, and
           the step's layers timed alone; train_host on the interpreted
           CartPole for 500 steps; the pixel CNN on Pong-v0 (B = 4, batch
           32, a 50,000-transition ring: 11.29 GB) for 300 steps with
           megastep and raster launch counts and peak memory; the CNN on
           the card against the CPU at 1e-5 under cuDNN's TF32 default;
           greedy returns of the Table I params
  numbers  env steps/s per id: classic and grid at B = 65,536 (CartPole-v1
           also at B = 4,096), Pong-v0 and Breakout-v0 at B = 4,096, K = 8,
           Multitask-v0 at B = 65,536, Maze-px and FrozenLake-px at 4,096
  bodies   every fused id on a real main-path chunk from its pool's reset:
           the megastep against its plain twin (the grid bodies bit for
           bit), kernel and plain times, the resets, the bound over this
           chunk's bytes and operations, and the chunk's split (the whole
           chunk, the kernel, the action sampling); the peak device memory
           of a Maze-v0 chunk
  split    Pong-v0 and Breakout-v0: both kernels against their plain
           versions on a real chunk, then per-chunk times of the two raster
           launches, the frame-stack select and the sampling
  train_profile  a torch.profiler window over 10 Table I steps carried on
           from phase train: wall and device-busy ms a step, idle share,
           launches a step
  lm_profile  a torch.profiler window over Yi-6B's decode ticks and one
           2,048-token prefill: wall and device-busy ms, idle share, the
           costliest kernels (last, since a profiler slows the launches
           that follow it)
then the kernels line, and last `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: the CUDA sources, built in parallel (one nvcc each)
SOURCES = ("megastep", "raster", "flash")
IDS = ("CartPole-v1", "MountainCar-v0", "Pendulum-v1", "Acrobot-v1")
PIXEL_IDS = ("Pong-v0", "Breakout-v0")
#: the grid and puzzle bodies of the megastep, and their fused ids
GRID = ("LightsOut", "FrozenLake", "CliffWalk", "Maze", "Snake")
GRID_IDS = tuple(f"{name}-v0" for name in GRID)
#: ids of this slice that run the vmap backend: Multitask (its dynamics
#: read the per-step key) and the grid pixel ids (their obs is not their
#: state, so the pixel pipeline does not fuse)
MULTITASK_ID, GRID_PX_IDS = "Multitask-v0", ("Maze-px", "FrozenLake-px")
GRID_RENDER_ID = "Maze-v0"
GOLDEN_IDS = IDS + ("CartPole-raw", "MountainCar-raw", "Pendulum-raw",
                    "Acrobot-raw", "Pong-v0", "Pong-raw", "Breakout-v0",
                    "Breakout-raw") + tuple(
    f"{name}-{v}" for name in GRID + ("Multitask",) for v in ("v0", "raw")
) + tuple(f"{name}-px" for name in ("FrozenLake", "CliffWalk", "Maze",
                                    "Snake"))
B_MAIN, B_SMALL, B_CHECK = 65536, 4096, 65536 + 37
K, STEPS, PARITY_STEPS = 32, 1024, 64
#: the pixel ids: B keeps one chunk's live tensors near 10 GB; K = 8 is the
#: JAX package's cap for pixel ids (benchmarks/fig1_env_throughput.py)
B_PIXEL, K_PIXEL = 4096, 8
RENDER_STEPS = 256
#: depths of this slice's vmap and render paths (steps per rollout)
MULTITASK_STEPS, GRID_PX_STEPS, GRID_RENDER_STEPS = 256, 128, 64
#: frames per raster check of this slice's scenes
GRID_FRAMES = 32768
RTOL, ATOL = 1e-5, 1e-6           # tests/conftest.py::assert_leaves_match
GOLDEN_TOL = 1e-4                 # tests/test_golden.py
TIMED_RUNS = 3

#: (name fragment, memory bytes/s, fp32 non-tensor FLOP/s, dense bf16
#: tensor-core FLOP/s), NVIDIA data sheets; the first fragment found in the
#: card's name applies. Its int32 rate is a quarter of the fp32 FLOP/s:
#: an SM issues 64 int32 ops a clock against 128 fp32 FMAs (256 FLOP).
CARDS = (("H100 PCIe", 2.0e12, 51e12, 756e12),
         ("H100 NVL", 3.9e12, 60e12, 835e12),
         ("H100", 3.35e12, 67e12, 989e12), ("H200", 4.8e12, 67e12, 989e12))

INT32_PER_FP32_FLOP = 0.25
#: float ops per lane-step of each body with TimeLimit, counted in
#: csrc/megastep.cu: each add, multiply, divide, compare, select, fabsf,
#: sinf and cosf is one, the TimeLimit fold included. CartPole's is a
#: count; the others are lower estimates: the grid and puzzle bodies one
#: per observation code stored, plus the move, the plane lookups, reward,
#: done and the TimeLimit fold, Snake four more per cell for its ages;
#: Acrobot four derivatives of ~30 ops; the rest their step's arithmetic.
#: Far below the bytes and integer bounds, they decide nothing.
FLOAT_OPS_PER_LANE_STEP = {"CartPole": 49, "MountainCar": 16, "Pendulum": 24,
                           "Acrobot": 120, "Pong": 30, "Breakout": 40,
                           "LightsOut": 37, "FrozenLake": 28, "CliffWalk": 62,
                           "Maze": 78, "Snake": 200}
#: int32 ops of one threefry-2x32 block (csrc/megastep.cu: 2 key xors, 2
#: adds, 20 rounds of add, funnel shift and xor, 5 injections of 3 adds);
#: every lane-step splits its key (2 blocks), and a lane-step that resets
#: draws its body's reset (the blocks below, csrc/megastep.cu's header)
THREEFRY_OPS = 79
RESET_BLOCKS = {"CartPole": 2, "MountainCar": 1, "Pendulum": 4, "Acrobot": 2,
                "Pong": 6, "Breakout": 4, "LightsOut": 8, "FrozenLake": 13,
                "CliffWalk": 30, "Maze": 46, "Snake": 18}
#: the reset-heavy kernel case: a TimeLimit of 3 over K = 32 steps
HEAVY_MAX_STEPS = 3
#: float ops of csrc/raster.cu, counted there: per pixel-segment pair (the
#: coverage, its clips and the running max; sqrtf and each division one
#: op), per segment staged (dx, dy, the squared length and its clamp) and
#: per pixel (its centre). The pairs these inputs need are those of
#: non-zero coverage: a pair of zero coverage cannot raise the max.
RASTER_OPS_PER_PIXEL_SEGMENT = 25
RASTER_OPS_PER_SEGMENT = 6
RASTER_OPS_PER_PIXEL = 4

#: uniform ranges of the classic state rows fed to the kernel check, wide
#: enough that episodes end, velocities clamp and angles wrap inside K steps
STATE_RANGES = {
    "CartPole": [(-2.4, 2.4), (-2.0, 2.0), (-0.21, 0.21), (-2.0, 2.0)],
    "MountainCar": [(-1.2, 0.6), (-0.07, 0.07)],
    "Pendulum": [(-3 * math.pi, 3 * math.pi), (-8.0, 8.0)],
    "Acrobot": [(-math.pi, math.pi), (-math.pi, math.pi),
                (-4 * math.pi, 4 * math.pi), (-9 * math.pi, 9 * math.pi)],
}
MAX_STEPS = {"CartPole": 500, "MountainCar": 200, "Pendulum": 200,
             "Acrobot": 500, "Pong": 1000, "Breakout": 1000,
             "LightsOut": 100, "FrozenLake": 100, "CliffWalk": 100,
             "Maze": 200, "Snake": 200}
KERNEL_K = {"Pong": K_PIXEL, "Breakout": K_PIXEL}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_row(name: str):
    """(memory bytes/s, fp32 non-tensor FLOP/s, dense bf16 tensor-core
    FLOP/s) of the named card."""
    for row in CARDS:
        if row[0] in name:
            return row[1:]
    raise RuntimeError(f"no data-sheet rates for {name!r}")


def megastep_bytes(b: int, k: int, s: int, o: int) -> int:
    """Bytes one megastep must move: each input read once, each output
    written once. s counts the TimeLimit row when there is one; the (B, 2)
    int64 keys are 4 floats' worth a lane each way."""
    reads = s + 4 + k                     # state, keys; act
    writes = s + 4 + k * (2 * o + 3)      # state, keys; obs, tobs, rew,
    return 4 * b * (reads + writes)       # done, trunc


def megastep_ops(name: str, b: int, k: int, resets: int):
    """(int32 ops, float ops) one megastep must do on these inputs: the key
    split of every lane-step and the reset of each of the `resets`
    lane-steps that reset (counted from the kernel's own done output), and
    the body's float arithmetic."""
    blocks = 2 * b * k + resets * RESET_BLOCKS[name]
    return THREEFRY_OPS * blocks, FLOAT_OPS_PER_LANE_STEP[name] * b * k


def raster_work(segs, intens, h: int, w: int):
    """What one raster launch must move and do on these scenes: segments
    and intensities read once, frames written once; ops over the
    pixel-segment pairs of non-zero coverage, counted on the scenes' device
    with the plain version's arithmetic, and (ops_all_pairs) over every
    pair of a live (nonzero-intensity) segment, the count of earlier
    versions of this bound."""
    from repro_torch.kernels.raster.ref import segment_coverage

    n, s = intens.shape
    live = int((intens != 0).sum())
    covered = sum(int((c > 0).sum()) for c in segment_coverage(segs, intens,
                                                                h, w))
    rest = n * s * RASTER_OPS_PER_SEGMENT + n * h * w * RASTER_OPS_PER_PIXEL
    return {"bytes": 4 * (n * s * 6 + n * h * w),
            "ops": covered * RASTER_OPS_PER_PIXEL_SEGMENT + rest,
            "ops_all_pairs": live * h * w * RASTER_OPS_PER_PIXEL_SEGMENT + rest,
            "covered_pairs": covered, "live_segments": live}


def bound(bytes_moved, ops, bw, flops, int_ops=0):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and each kind of operations over its peak rate."""
    bytes_ms = 1e3 * bytes_moved / bw
    ops_ms = max(1e3 * ops / flops,
                 1e3 * int_ops / (INT32_PER_FP32_FLOP * flops))
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def timed(fn, runs, sync):
    """Median seconds of `runs` calls of fn, each ended by `sync()`."""
    out = []
    for _ in range(runs):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def event_ms(torch, fn, n, warmup=2):
    """Mean device ms of fn over n calls, by CUDA events, after warmup."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def fresh_rows_calls():
    """The plain megastep's reset precompute, counted per call: no chunk of
    the CUDA path calls it."""
    from repro_torch.kernels.envstep import ops

    return ops.fresh_rows.calls


def counters():
    """{kernel: its wrapper}; each wrapper counts its launches."""
    from repro_torch.kernels.attention import flash_attention_cuda
    from repro_torch.kernels.envstep import megastep_cuda
    from repro_torch.kernels.raster import rasterize_cuda

    return {"megastep": megastep_cuda, "raster": rasterize_cuda,
            "flash": flash_attention_cuda}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


@contextlib.contextmanager
def uncounted():
    """Launches made to compare or time a kernel are not main-path
    launches: the counts are put back on exit."""
    saved = read_counts()
    try:
        yield
    finally:
        for name, fn in counters().items():
            fn.launches = saved[name]


# -- phases --------------------------------------------------------------------

def phase_device(torch):
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi, "name": name, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, smi


_BODY = re.compile(r"(CartPole|MountainCar|Pendulum|Acrobot|Pong|Breakout|"
                   r"LightsOut|FrozenLake|CliffWalk|Maze|Snake)ELb([01])")


_FLASH = re.compile(r"flash_(bf16_)?kernelILi(\d+)E")


def _entry_name(mangled: str) -> str:
    m = _BODY.search(mangled)
    if m:
        return m[1] + (" +TimeLimit" if m[2] == "1" else "")
    m = _FLASH.search(mangled)
    if m:
        return f"flash {'bfloat16' if m[1] else 'float32'} D={m[2]}"
    return "raster_kernel" if "raster_kernel" in mangled else mangled


def ptxas_report(logs):
    """{source: {kernel instantiation: "registers ...; stack/spills"}}."""
    out = {}
    for src, log in logs.items():
        rows, entry = {}, None
        for ln in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)", ln)
            if m:
                entry = _entry_name(m[1])
            elif entry and ("registers" in ln or "spill" in ln):
                text = ln.split(":", 1)[-1].strip()
                rows[entry] = f"{rows[entry]}; {text}" if entry in rows else text
        out[src] = rows
    return out


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build(SOURCES)
    for name in SOURCES:
        build.load(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs), "ptxas": ptxas_report(logs)})


def arcade_rows(rng, name, lead, b):
    """Arcade state rows: balls that reach the paddles, walls and edges
    inside K steps; Breakout's in and around the brick region over random
    0/1 boards, a fifth of them down to one brick, so that bricks break
    and boards clear."""
    u = lambda lo, hi: rng.uniform(lo, hi, lead + (b,))
    sign = lambda: (rng.random(lead + (b,)) < 0.5) * 2.0 - 1.0
    if name == "Pong":
        return [u(0.0, 1.0), u(0.0, 1.0), sign() * 0.035, u(-0.05, 0.05),
                u(0.12, 0.88), u(0.12, 0.88)]
    board = rng.random(lead + (24, b)) < 0.5
    board &= rng.random(lead + (1, b)) < 0.8
    board[..., 9, :] = True
    return [u(0.0, 1.0), u(0.05, 0.5), u(-0.04, 0.04), sign() * u(0.02, 0.04),
            u(0.14, 0.86), *(board[..., i, :] for i in range(24))]


def lane_keys(torch, rng, b, device):
    """(b, 2) int64 auto-reset keys of numpy-drawn uint32 words."""
    return torch.as_tensor(rng.integers(0, 2**32, (b, 2)), dtype=torch.int64,
                           device=device).contiguous()


def step_counters(rng, name, max_steps, k, b):
    """TimeLimit rows: near the limit for the arcade and grid bodies, so
    that the limit cuts inside K steps; anywhere below it for the classic
    ones, whose episodes end by themselves."""
    lo = 0 if name in STATE_RANGES else max(0, max_steps - 2 * k)
    return rng.integers(lo, max_steps, (1, b))


def kernel_inputs(torch, name, max_steps, b, k, seed, device):
    """numpy-seeded megastep operands (state, keys, actions) of a classic
    or arcade body."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if name in STATE_RANGES:
        rows = [rng.uniform(lo, hi, b) for lo, hi in STATE_RANGES[name]]
    else:
        rows = arcade_rows(rng, name, (), b)
    if max_steps is not None:
        rows.append(step_counters(rng, name, max_steps, k, b)[0])
    if name == "Pendulum":
        act = rng.uniform(-3.0, 3.0, (k, b))
    else:
        act = rng.integers(0, 3 if name != "CartPole" else 2, (k, b))
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                     device=device).contiguous()
    return [as_t(np.stack(rows)), lane_keys(torch, rng, b, device), as_t(act)]


#: the megastep's outputs, in order
OUTPUTS = ("new_state", "final_keys", "obs", "terminal_obs", "reward", "done",
           "truncated")
EXACT_ALL = OUTPUTS


def compare(torch, got, want, what, exact=("done", "truncated")):
    """The `exact` outputs and the final keys bit for bit, floats within
    RTOL/ATOL; max abs error."""
    err = 0.0
    for n, g, w in zip(OUTPUTS, got, want):
        if n in exact or n == "final_keys":
            if not torch.equal(g, w):
                raise AssertionError(f"{what}: {n} differs in "
                                     f"{int((g != w).sum())} places")
            continue
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL,
                                   msg=lambda m: f"{what}: {n}: {m}")
        err = max(err, float((g - w).abs().max()))
    return err


def plain_megastep(core, spec, ops, max_steps):
    """The kernel's plain twin on the same operands: the auto-reset key
    chain and fresh rows of `fresh_rows`, then `megastep_ref`."""
    from repro_torch.kernels.envstep import env_megastep

    return env_megastep(spec, *ops, core=core, max_steps=max_steps,
                        backend="torch")


def _envs():
    from repro_torch.envs.arcade import Breakout, Pong
    from repro_torch.envs.classic import Acrobot, CartPole, MountainCar, Pendulum
    from repro_torch.envs.grid import CliffWalk, FrozenLake, Maze, Snake
    from repro_torch.envs.puzzle import LightsOut

    return {"CartPole": CartPole(), "MountainCar": MountainCar(),
            "Pendulum": Pendulum(), "Acrobot": Acrobot(), "Pong": Pong(),
            "Breakout": Breakout(), "LightsOut": LightsOut(),
            "FrozenLake": FrozenLake(), "CliffWalk": CliffWalk(),
            "Maze": Maze(), "Snake": Snake()}


#: Snake's cells in boustrophedon order: a body laid along it is a legal
#: snake of any length
SNAKE_PATH = [r * 6 + (c if r % 2 == 0 else 5 - c)
              for r in range(6) for c in range(6)]


def grid_state_rows(rng, name, b):
    """numpy-seeded (S, b) state rows of a grid or puzzle body, in the env's
    own form (0/1 planes, integer cells), and (b,) actions steering toward
    the terminal cases: LightsOut boards one press from solved and that
    press; agents among random holes, cliffs and walls, a third of them
    beside the goal and stepping into it (a Maze goal one step away); snakes
    of every length laid along SNAKE_PATH, half of them turning into their
    food, a quarter one eat from filling the board, the rest heading into
    walls and their own body at random."""
    import numpy as np

    act = rng.integers(0, 25 if name == "LightsOut" else 4, b)
    lanes = np.arange(b)
    if name == "LightsOut":
        press = rng.integers(0, 25, b)[:, None]
        cr, cc = np.arange(25) // 5, np.arange(25) % 5
        cross = (((cr == press // 5) & (np.abs(cc - press % 5) <= 1))
                 | ((cc == press % 5) & (np.abs(cr - press // 5) <= 1)))
        near = lanes % 3 == 0
        board = np.where(near[:, None], cross, rng.random((b, 25)) < 0.5)
        act = np.where(near, press[:, 0], act)
        return np.concatenate([board.T, rng.integers(0, 90, (1, b))]
                              ).astype(np.float32), act
    toward = lambda a, z, n: np.select([z - a == 1, z - a == -1, z - a == n],
                                       [2, 0, 1], 3)
    if name == "Snake":
        path = np.asarray(SNAKE_PATH)
        length = np.where(lanes % 4 == 0, 35, rng.integers(1, 35, b))
        j = np.arange(36)
        ages = np.zeros((b, 36))
        ages[:, path] = np.where(j < length[:, None], j + 1, 0)
        head, food = path[length - 1], path[length]
        act = np.where(lanes % 2 == 0, toward(head, food, 6), act)
        scalars = np.stack([head, food, length, rng.integers(0, 40, b)])
        return np.concatenate([scalars, ages.T, rng.random((36, b))]
                              ).astype(np.float32), act
    n_rows, n_cols = {"FrozenLake": (4, 4), "CliffWalk": (4, 12),
                      "Maze": (8, 8)}[name]
    m = n_rows * n_cols
    plane = rng.random((b, m)) < (0.25 if name == "CliffWalk" else 0.35)
    goal = (rng.integers(m // 2, m, b) if name == "Maze"
            else np.full(b, m - 1))
    if name == "CliffWalk":
        plane[:, (n_rows - 1) * n_cols] = False       # the start
    plane[lanes, goal] = False
    score = rng.random((b, m))
    score[plane] = -1.0
    score[lanes, goal] = -1.0
    pos = score.argmax(1)                 # a random free cell, not the goal
    near = lanes % 3 == 0
    from_left = goal % n_cols != 0
    beside = np.where(from_left, goal - 1, goal - n_cols)
    pos = np.where(near, beside, pos)
    plane[lanes[near], beside[near]] = False
    act = np.where(near, np.where(from_left, 2, 1), act)
    lead = [pos] if name != "Maze" else [pos, goal]
    return np.concatenate([np.stack(lead), plane.T]).astype(np.float32), act


def grid_kernel_inputs(torch, name, max_steps, b, k, seed, device):
    """Megastep operands of a grid or puzzle body: the state and the first
    step's actions from `grid_state_rows`, random actions after it, and
    random keys."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows, act0 = grid_state_rows(rng, name, b)
    act = rng.integers(0, 25 if name == "LightsOut" else 4, (k, b))
    act[0] = act0
    if max_steps is not None:
        rows = np.concatenate([rows, step_counters(rng, name, max_steps, k,
                                                   b)])
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    return [as_t(rows).contiguous(), lane_keys(torch, rng, b, device),
            as_t(act).contiguous()]


def phase_kernel(torch, device):
    """Every body against its plain twin, with its TimeLimit, without one,
    and reset-heavy; the resets per case and per body."""
    from repro_torch.core.wrappers import TimeLimit
    from repro_torch.kernels.envstep import BODIES, megastep_cuda
    from repro_torch.kernels.envstep.specs import spec_for

    t0 = time.perf_counter()
    rows, worst, resets = [], 0.0, {}
    with uncounted():
        for i, (name, env) in enumerate(_envs().items()):
            spec = spec_for(env)
            arcade = name in KERNEL_K
            exact = ("reward", "done", "truncated") if arcade else (
                "done", "truncated")
            if name in GRID:
                exact = EXACT_ALL
            for max_steps in (MAX_STEPS[name], None, HEAVY_MAX_STEPS):
                heavy = max_steps == HEAVY_MAX_STEPS
                k = K if heavy else KERNEL_K.get(name, K)
                inputs = grid_kernel_inputs if name in GRID else kernel_inputs
                ops = inputs(torch, name, max_steps, B_CHECK, k, i, device)
                core = env if max_steps is None else TimeLimit(env, max_steps)
                got = megastep_cuda(BODIES[name].kernel_id, *ops,
                                    max_steps=max_steps)
                want = plain_megastep(core, spec, ops, max_steps)
                err = compare(torch, got, want,
                              f"{name} max_steps={max_steps} K={k}", exact)
                worst = max(worst, err)
                reward, done, trunc = got[4:]
                case = {"body": name, "max_steps": max_steps, "K": k,
                        "max_abs_err": err, "resets": int(done.sum()),
                        "truncations": int(trunc.sum())}
                if heavy and case["resets"] == 0:
                    raise AssertionError(f"{name}: no lane reset in the "
                                         "reset-heavy case")
                resets[name] = resets.get(name, 0) + case["resets"]
                if arcade or name in GRID:
                    case["reward_sum"] = float(reward.sum())
                if name in ("Maze", "Snake"):   # goals; eats, wins included
                    case["reward_1"] = int((reward == 1).sum())
                    case["reward_1_and_done"] = int(
                        ((reward == 1) & (done == 1)).sum())
                if name == "Breakout":
                    case["bricks_broken"] = int((reward >= 1).sum())
                    case["boards_cleared"] = int((reward >= 5).sum())
                rows.append(case)
    emit({"phase": "kernel", "seconds": time.perf_counter() - t0,
          "B": B_CHECK, "rtol": RTOL, "atol": ATOL,
          "exact": "final keys, done, truncated; reward too for Pong and "
                   "Breakout; every output for the grid and puzzle bodies",
          "resets_per_body": resets, "cases": rows})
    return worst


def arcade_scenes(torch, name, n, seed, device):
    """(segs (n, S, 5), intens (n, S)) of numpy-seeded Pong or Breakout
    states, built by the env's own `scene` on the card."""
    import numpy as np

    from repro_torch.kernels.envstep.specs import spec_for

    env = _envs()[name]
    rows = np.stack(arcade_rows(np.random.default_rng(seed), name, (), n))
    state = spec_for(env).unflatten(
        torch.as_tensor(rows, dtype=torch.float32, device=device))
    segs, intens = env.scene(state)
    return segs.contiguous(), intens.contiguous()


def grid_scenes(torch, name, n, seed, device):
    """(segs, intens) of n numpy-seeded states of a grid, puzzle or
    Multitask env, built by the env's own `scene` on the card: point
    capsules, FrozenLake's holes and Snake's empty cells at intensity 0."""
    import numpy as np

    from repro_torch.envs.multitask import Multitask, MultitaskState
    from repro_torch.kernels.envstep.specs import spec_for

    rng = np.random.default_rng(seed)
    if name == "Multitask":
        env = Multitask()
        u = lambda lo, hi: torch.as_tensor(rng.uniform(lo, hi, n),
                                           dtype=torch.float32, device=device)
        lane = lambda: torch.as_tensor(rng.integers(0, 3, n),
                                       dtype=torch.int32, device=device)
        state = MultitaskState(u(0.05, 0.95), u(0.1, 0.9), u(0.0, 1.0),
                               lane(), lane(), u(0.0, 1.0), lane())
    else:
        env = _envs()[name]
        rows = torch.as_tensor(grid_state_rows(rng, name, n)[0],
                               device=device)
        state = spec_for(env).unflatten(rows)
    segs, intens = env.scene(state)
    return segs.contiguous(), intens.contiguous()


def random_scenes(torch, n, s, seed, device):
    """Random capsules, segment 0 a dot and the last one padding."""
    g = torch.Generator(device=device).manual_seed(seed)
    segs = torch.rand((n, s, 5), generator=g, device=device)
    segs[..., 4] *= 0.05
    segs[:, 0, 2:4] = segs[:, 0, 0:2]
    intens = torch.rand((n, s), generator=g, device=device)
    intens[:, -1] = 0.0
    return segs.contiguous(), intens.contiguous()


def raster_check(torch, segs, intens, h, w, what):
    """The kernel against its plain version, bit for bit. Returns (max abs
    error, the kernel's frames)."""
    from repro_torch.kernels.raster import rasterize_cuda, rasterize_ref

    got = rasterize_cuda(segs, intens, h, w)
    want = rasterize_ref(segs, intens, h, w)
    differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    if differ:
        raise AssertionError(f"raster {what}: {differ} pixels differ from the "
                             "plain version")
    return float((got - want).abs().max()), got


def raster_times(torch, segs, intens, h, w, bw, flops):
    from repro_torch.kernels.raster import rasterize_cuda, rasterize_ref

    ms = event_ms(torch, lambda: rasterize_cuda(segs, intens, h, w), 20)
    plain_ms = event_ms(torch, lambda: rasterize_ref(segs, intens, h, w), 2,
                        warmup=1)
    work = raster_work(segs, intens, h, w)
    bound_ms, bound_by = bound(work["bytes"], work["ops"], bw, flops)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, **work}


def phase_raster(torch, device, bw, flops):
    t0 = time.perf_counter()
    frames = K_PIXEL * B_PIXEL
    cases, worst = [], 0.0
    with uncounted():
        for i, (what, n, s, h, w) in enumerate((
                ("Pong scenes", frames, 4, 84, 84),
                ("Breakout scenes", frames, 26, 84, 84),
                ("ragged frame count", frames + 37, 5, 84, 84),
                ("non-square frame", 517, 7, 60, 100))):
            if what.startswith(("Pong", "Breakout")):
                segs, intens = arcade_scenes(torch, what.split()[0], n, i,
                                             device)
            else:
                segs, intens = random_scenes(torch, n, s, i, device)
            err, out = raster_check(torch, segs, intens, h, w, what)
            if not bool(out.max() > 0.5):
                raise AssertionError(f"raster {what}: nothing drawn")
            worst = max(worst, err)
            case = {"case": what, "frames": n, "S": s, "H": h, "W": w,
                    "max_abs_err": err}
            if i < 2:
                case.update(raster_times(torch, segs, intens, h, w, bw,
                                         flops))
            cases.append(case)
        # this slice's scenes, bit for bit: the grid suite's point capsules
        # (S = 16, 48, 64, 36), LightsOut's 25 and Multitask's 5
        grid_times = None
        for i, name in enumerate(GRID + ("Multitask",)):
            segs, intens = grid_scenes(torch, name, GRID_FRAMES, 10 + i,
                                       device)
            err, out = raster_check(torch, segs, intens, 84, 84,
                                    f"{name} scenes")
            if not bool(out.max() > 0.5):
                raise AssertionError(f"raster {name} scenes: nothing drawn")
            worst = max(worst, err)
            case = {"case": f"{name} scenes", "frames": GRID_FRAMES,
                    "S": intens.shape[1], "H": 84, "W": 84,
                    "live_segments_per_frame": float(
                        (intens != 0).sum()) / GRID_FRAMES,
                    "max_abs_err": err}
            if name == "Maze":
                grid_times = raster_times(torch, segs, intens, 84, 84, bw,
                                          flops)
                case.update(grid_times)
            cases.append(case)
    emit({"phase": "raster", "seconds": time.perf_counter() - t0,
          "exact": "every case, bit for bit", "cases": cases,
          "clock": "CUDA events: kernel over 20 launches, plain over 2"})
    return worst, grid_times


def check_rollout(torch, env_id, rew, eps, b):
    if rew.shape != (b,) or eps.shape != (b,):
        raise AssertionError(f"{env_id}: rollout shapes {rew.shape}, {eps.shape}")
    if not bool(torch.isfinite(rew).all()) or int(eps.min()) < 0:
        raise AssertionError(f"{env_id}: non-finite returns or negative "
                             "episode counts")


def drive(torch, sync, env_id, b, unroll, steps, key, device, want,
          render=False):
    """One rollout through `make_vec`; the launch counts of that rollout
    alone must equal `want`."""
    import repro_torch

    pool = repro_torch.make_vec(env_id, b, unroll=unroll, device=device)
    before = read_counts()
    t0 = time.perf_counter()
    rew, eps, last = pool.rollout(steps, key, render=render)
    sync()
    seconds = time.perf_counter() - t0
    launches = {n: read_counts()[n] - before[n] for n in before}
    want = {"flash": 0, **want}
    if launches != want:
        raise AssertionError(f"{env_id}: launches {launches} in a {steps}-step"
                             f" rollout (render={render}), want {want}")
    check_rollout(torch, env_id, rew, eps, b)
    row = {"id": env_id, "B": b, "unroll": unroll, "steps": steps,
           "backend": pool.backend, "launches": launches,
           "first_rollout_s": seconds, "episodes": int(eps.sum()),
           "mean_return_per_step": float(rew.sum()) / (b * steps)}
    if render:
        h, w = pool.env.unwrapped.frame_shape
        if last.shape != (b, h, w) or not bool(
                ((last >= 0) & (last <= 1)).all()) or not bool(last.max() > 0):
            raise AssertionError(f"{env_id}: render rollout's last frame is "
                                 f"{tuple(last.shape)}, outside [0, 1] or blank")
        row["last_frame_mean"] = float(last.mean())
    return pool, row


def phase_main(torch, device, sync):
    from repro_torch import random as R

    from repro_torch.kernels.envstep import ops

    t0 = time.perf_counter()
    key = R.PRNGKey(0, device)
    pools, rows, paths = {}, [], {}
    ops.fresh_rows.calls = 0

    # classic control (PR 11's path): megastep only
    reset_counts()
    for env_id in IDS:
        pools[env_id], row = drive(torch, sync, env_id, B_MAIN, K, STEPS, key,
                                   device, {"megastep": STEPS // K,
                                            "raster": 0})
        rows.append(row)
    paths["classic"] = read_counts()

    # the pixel path: per chunk one megastep and two raster launches, and
    # one raster launch for the reset's frames
    reset_counts()
    for env_id in PIXEL_IDS:
        chunks = STEPS // K_PIXEL
        pools[env_id], row = drive(torch, sync, env_id, B_PIXEL, K_PIXEL,
                                   STEPS, key, device,
                                   {"megastep": chunks,
                                    "raster": 2 * chunks + 1})
        rows.append(row)
    paths["pixel"] = read_counts()

    # render mode: one fused step and one frame per step, and the first
    # frame of the reset
    reset_counts()
    render_pools = {}
    for env_id in IDS:
        render_pools[env_id], row = drive(
            torch, sync, env_id, B_MAIN, K, RENDER_STEPS, key, device,
            {"megastep": RENDER_STEPS, "raster": RENDER_STEPS + 1},
            render=True)
        rows.append(row)
    paths["render"] = read_counts()

    # the grid and puzzle ids: the megastep's five packed bodies
    reset_counts()
    for env_id in GRID_IDS:
        pools[env_id], row = drive(torch, sync, env_id, B_MAIN, K, STEPS, key,
                                   device, {"megastep": STEPS // K,
                                            "raster": 0})
        rows.append(row)
    paths["grid"] = read_counts()

    # Multitask on the vmap backend: its dynamics read the per-step key, so
    # it has no megastep body and launches no kernel
    reset_counts()
    vmap_pools = {}
    vmap_pools[MULTITASK_ID], row = drive(
        torch, sync, MULTITASK_ID, B_MAIN, 1, MULTITASK_STEPS, key, device,
        {"megastep": 0, "raster": 0})
    rows.append(row)
    paths["multitask"] = read_counts()

    # the grid pixel ids on the vmap backend: per step the raster renders
    # the stepped frames (ObsToPixels.step) and the fresh reset frames
    # (AutoReset resets the whole stack every step), and once the reset
    reset_counts()
    for env_id in GRID_PX_IDS:
        vmap_pools[env_id], row = drive(
            torch, sync, env_id, B_PIXEL, 1, GRID_PX_STEPS, key, device,
            {"megastep": 0, "raster": 2 * GRID_PX_STEPS + 1})
        rows.append(row)
    paths["grid_pixels"] = read_counts()
    for env_id, pool in vmap_pools.items():
        if pool.backend != "vmap":
            raise AssertionError(f"{env_id} ran {pool.backend}, not vmap")

    # a grid render rollout: one fused step and one frame per step
    reset_counts()
    render_pools[GRID_RENDER_ID], row = drive(
        torch, sync, GRID_RENDER_ID, B_MAIN, K, GRID_RENDER_STEPS, key,
        device, {"megastep": GRID_RENDER_STEPS,
                 "raster": GRID_RENDER_STEPS + 1}, render=True)
    rows.append(row)
    paths["grid_render"] = read_counts()

    # Steady state with every host sync an error: the port's counterpart of
    # the JAX package's zero-host-transfer check on the compiled rollout.
    for env_id, pool in pools.items():
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = pool.rollout(STEPS, key)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check_rollout(torch, env_id, out[0], out[1], pool.num_envs)
    if fresh_rows_calls():
        raise AssertionError(f"{fresh_rows_calls()} calls of fresh_rows on "
                             "the CUDA path: the kernel resets in-kernel")
    launches = {n: sum(p[n] for p in paths.values()) for n in
                ("megastep", "raster")}
    emit({"phase": "main", "seconds": time.perf_counter() - t0, "rows": rows,
          "launches_per_path": paths, "launches": launches,
          "fresh_rows_calls": fresh_rows_calls(),
          "sync_free_steady_state": list(pools)})
    return pools, vmap_pools, render_pools, launches


def phase_parity(torch, device):
    import repro_torch
    from repro_torch import random as R
    from repro_torch.core.spaces import sample_batch

    t0 = time.perf_counter()
    rows = []
    key = R.PRNGKey(1, device)
    for env_id in IDS + PIXEL_IDS + GRID_IDS:
        pixel = env_id in PIXEL_IDS
        b, k = (B_PIXEL, K_PIXEL) if pixel else (B_MAIN, K)
        out, chunk = {}, {}
        for backend in ("cuda", "torch"):
            pool = repro_torch.make_vec(env_id, b, backend=backend, unroll=k,
                                        device=device)
            out[backend] = pool.rollout(PARITY_STEPS, key)
            if pixel:       # one chunk's frames, from the same carry
                h = pool.xla()
                acts = sample_batch(pool.action_space, R.fold_in(
                    key, torch.arange(k, device=device)), b)
                chunk[backend] = h.step_many(h.init(key), acts)[1]
        rew_c, eps_c, _ = out["cuda"]
        rew_t, eps_t, _ = out["torch"]
        if not torch.equal(eps_c, eps_t):
            raise AssertionError(f"{env_id}: episode counts differ in "
                                 f"{int((eps_c != eps_t).sum())} lanes")
        torch.testing.assert_close(rew_c, rew_t, rtol=RTOL, atol=ATOL)
        if env_id in GRID_IDS and not torch.equal(rew_c, rew_t):
            raise AssertionError(f"{env_id}: rewards differ")
        row = {"id": env_id, "B": b, "episodes": int(eps_c.sum()),
               "max_abs_err_sum_reward": float((rew_c - rew_t).abs().max())}
        if pixel:
            c, t = chunk["cuda"], chunk["torch"]
            err = 0.0
            for what, g, w in (("obs", c.obs, t.obs),
                               ("terminal_obs", c.info["terminal_obs"],
                                t.info["terminal_obs"])):
                torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL,
                                           msg=lambda m: f"{env_id} {what}: {m}")
                err = max(err, float((g - w).abs().max()))
            for what in ("reward", "done"):
                if not torch.equal(getattr(c, what), getattr(t, what)):
                    raise AssertionError(f"{env_id}: chunk {what} differs")
            row["chunk_frames_max_abs_err"] = err
            del chunk
        rows.append(row)
    emit({"phase": "parity", "seconds": time.perf_counter() - t0,
          "steps": PARITY_STEPS, "rows": rows})


def phase_golden(device):
    """The tests/test_envspec.py::_pool_trace recipe through the port, on
    the backend `make_vec` picks: the CUDA megastep where the id has a
    body, else vmap (Multitask, the grid pixel ids)."""
    import numpy as np

    import repro_torch
    from repro_torch import random as R
    from repro_torch.core.spaces import sample_batch

    t0 = time.perf_counter()
    worst, backends = {}, {}
    for env_id in GOLDEN_IDS:
        want = json.loads((ROOT / "tests" / "golden" / f"{env_id}.json")
                          .read_text())
        b = want["batch"]
        pool = repro_torch.make_vec(env_id, b, device=device)
        backends[env_id] = pool.backend
        h = pool.xla()
        key = R.PRNGKey(sum(map(ord, env_id)), device)
        ps = h.init(key)
        np.testing.assert_allclose(float(ps.obs.double().sum()),
                                   want["reset_obs_sum"], rtol=GOLDEN_TOL,
                                   atol=GOLDEN_TOL, err_msg=env_id)
        rows = []
        for t in range(want["steps"]):
            a = sample_batch(pool.action_space, R.fold_in(key, 1000 + t), b)
            ps, out = h.step(ps, a, R.fold_in(key, t))
            rows.append([float(out.obs.double().sum()),
                         float(out.reward.double().sum()),
                         int(out.done.sum())])
        np.testing.assert_allclose(rows, want["rows"], rtol=GOLDEN_TOL,
                                   atol=GOLDEN_TOL, err_msg=env_id)
        worst[env_id] = float(np.abs(np.subtract(rows, want["rows"])).max())
    emit({"phase": "golden", "seconds": time.perf_counter() - t0,
          "backends": backends, "max_abs_err": worst})


# -- training: DQN, the paper's learner (Table I, Fig. 2) ----------------------

TRAIN_GOLDEN_IDS = ("dqn/CartPole-v1", "dqn/FrozenLake-v0")
#: src/repro/train/fused.py::golden_train_setup's DQN recipe
TRAIN_GOLDEN_CFG = dict(num_envs=2, memory_size=96, learn_start=16,
                        batch_size=8, exploration_steps=48,
                        target_update_freq=13)
TRAIN_GOLDEN_STEPS = 64
TRAIN_GOLDEN_EXACT = ("final_key", "replay_ptr", "replay_size",
                      "replay_done_sum")
#: benchmarks/fig2_dqn_training.py: `_cfg()` and run()'s default budget
TABLE_I_STEPS = 2000
HOST_STEPS = 500
#: the pixel CNN of tests/test_arcade.py's Pong-v0 test at Table I's memory
#: and batch: the ring holds 2 × 50,000 frame stacks of 4×84×84 f32
PONG_CFG = dict(network="cnn", memory_size=50_000, batch_size=32,
                num_envs=4, learn_start=100)
PONG_STEPS = 300
CNN_TOL = 1e-5
GREEDY_EPISODES = 8
#: the learner's pool widths: Table I (1), the goldens (2), TUNED (4)
LEARNER_WIDTHS = (1, 2, 4)
TRAIN_PROFILE_STEPS = 10
RANGE_COST_CALLS = 10_000


def learner_width_check(torch, device):
    """The megastep at the learner's widths against its plain twin: the
    bodies the training paths run (CartPole, FrozenLake, Pong), B = 1, 2,
    4, a K = 1 chunk (a training step's) under the env's TimeLimit and a
    reset-heavy K = 32 one under a TimeLimit of 3."""
    from repro_torch.core.wrappers import TimeLimit
    from repro_torch.kernels.envstep import BODIES, megastep_cuda
    from repro_torch.kernels.envstep.specs import spec_for

    envs, worst, cases = _envs(), 0.0, []
    with uncounted():
        for i, name in enumerate(("CartPole", "FrozenLake", "Pong")):
            env = envs[name]
            spec = spec_for(env)
            exact = EXACT_ALL if name in GRID else (
                ("reward", "done", "truncated") if name in KERNEL_K
                else ("done", "truncated"))
            inputs = grid_kernel_inputs if name in GRID else kernel_inputs
            for b in LEARNER_WIDTHS:
                for max_steps, k in ((MAX_STEPS[name], 1),
                                     (HEAVY_MAX_STEPS, K)):
                    ops = inputs(torch, name, max_steps, b, k, 100 + i,
                                 device)
                    got = megastep_cuda(BODIES[name].kernel_id, *ops,
                                        max_steps=max_steps)
                    want = plain_megastep(TimeLimit(env, max_steps), spec,
                                          ops, max_steps)
                    err = compare(torch, got, want, f"{name} B={b} K={k} "
                                  f"max_steps={max_steps}", exact)
                    worst = max(worst, err)
                    cases.append({"body": name, "B": b, "K": k,
                                  "max_steps": max_steps, "max_abs_err": err,
                                  "resets": int(got[5].sum())})
    return worst, cases


def run_training(torch, env, cfg, steps, seed, device):
    """`steps` steps of `make_train_step` from `dqn_init`, every step after
    the first with host syncs made errors, a CUDA event after each step.
    Returns (state, apply_fn, losses (steps,), seconds, device ms per step,
    launches)."""
    from repro_torch import random as R
    from repro_torch.rl import dqn

    state, apply_fn = dqn.dqn_init(env, cfg, R.PRNGKey(seed, device),
                                   device=device)
    step_fn = dqn.make_train_step(env, apply_fn, cfg, device)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    losses = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    events[0].record()
    try:
        for i in range(steps):
            if i == 1:
                torch.cuda.set_sync_debug_mode("error")
            state, metrics = step_fn(state)
            losses.append(metrics["loss"])
            events[i + 1].record()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    return state, apply_fn, torch.stack(losses), seconds, step_ms, counts


def phase_train(torch, device):
    """DQN through the port's learner on the card: the megastep at the
    learner's widths, the two training goldens, Table I on CartPole-v1, train_host on the interpreted
    CartPole, the pixel CNN on Pong-v0 at Table I's memory, the CNN on the
    card against the CPU under PyTorch's TF32 default, greedy returns."""
    import dataclasses

    import numpy as np
    from torch.utils._pytree import tree_map

    import repro_torch
    from repro_torch import random as R
    from repro_torch.configs.cairl_dqn import PAPER_TABLE_I
    from repro_torch.envs.baseline_python import CartPolePy
    from repro_torch.rl import dqn

    t0 = time.perf_counter()
    out = {"phase": "train"}
    mega_err, out["learner_widths"] = learner_width_check(torch, device)

    # 1. the committed training goldens, through train_compiled on "cuda"
    goldens = {}
    for gid in TRAIN_GOLDEN_IDS:
        want = json.loads((ROOT / "tests" / "golden" /
                           f"train_{gid.replace('/', '_')}.json").read_text())
        env = repro_torch.make(gid.split("/")[1])
        cfg = dqn.DQNConfig(**TRAIN_GOLDEN_CFG, env_backend="cuda")
        reset_counts()
        state, apply_fn, _ = dqn.train_compiled(
            env, cfg, TRAIN_GOLDEN_STEPS, R.PRNGKey(sum(map(ord, gid)),
                                                    device), device=device)
        counts = read_counts()
        if counts["megastep"] != TRAIN_GOLDEN_STEPS:
            raise AssertionError(f"{gid}: {counts['megastep']} megastep "
                                 f"launches in {TRAIN_GOLDEN_STEPS} steps")
        got = dqn.golden_checksums(env, state, apply_fn)
        for k in TRAIN_GOLDEN_EXACT:
            if got[k] != want[k]:
                raise AssertionError(f"{gid}.{k}: {got[k]} != {want[k]}")
        floats = [k for k, v in want.items() if isinstance(v, float)]
        for k in floats:
            np.testing.assert_allclose(got[k], want[k], rtol=GOLDEN_TOL,
                                       atol=GOLDEN_TOL, err_msg=f"{gid}.{k}")
        goldens[gid] = {"megastep_launches": counts["megastep"],
                        "max_abs_err": max(abs(got[k] - want[k])
                                           for k in floats)}
    out["goldens"] = goldens

    # 2. Table I on CartPole-v1 (fig2's compiled row), host syncs errors
    env = repro_torch.make("CartPole-v1")
    cfg = dataclasses.replace(PAPER_TABLE_I, num_envs=1, learn_start=100,
                              env_backend="cuda")
    state, apply_fn, loss, sec, step_ms, counts = run_training(
        torch, env, cfg, TABLE_I_STEPS, 0, device)
    if counts["megastep"] != TABLE_I_STEPS or counts["raster"]:
        raise AssertionError(f"Table I: launches {counts}, want "
                             f"{TABLE_I_STEPS} megastep, 0 raster")
    if not bool(torch.isfinite(loss).all()):
        raise AssertionError("Table I: a loss is not finite")
    greedy = dqn.greedy_returns(env, apply_fn, state.params,
                                R.PRNGKey(123, device),
                                episodes=GREEDY_EPISODES, device=device)
    out["table_i"] = {
        "id": "CartPole-v1", "steps": TABLE_I_STEPS, "B": 1,
        "seconds": sec, "transitions_per_s": TABLE_I_STEPS / sec,
        "step_ms_median": statistics.median(step_ms),
        "step_ms_first": step_ms[0],
        "clock": "CUDA events between steps (device timeline); seconds: "
                 "host clock and a synchronize",
        "launches": counts, "sync_free_after_step": 1,
        "loss_finite": True, "loss_last": float(loss[-1]),
        "greedy_returns": [float(x) for x in greedy]}
    table_i = (env, cfg, state, apply_fn)

    # 3. the Gym row's counterpart: the interpreted CartPole, one transition
    # a call, the same learner on the card
    t1 = time.perf_counter()
    _, host_returns = dqn.train_host(CartPolePy, env, cfg, HOST_STEPS,
                                     R.PRNGKey(0, device), device=device)
    torch.cuda.synchronize()
    out["train_host"] = {"steps": HOST_STEPS,
                         "seconds": time.perf_counter() - t1,
                         "episodes": len(host_returns)}

    # 4. the pixel CNN on Pong-v0: Table I's 50,000-transition ring resident
    pong = repro_torch.make("Pong-v0")
    pcfg = dqn.DQNConfig(**PONG_CFG, env_backend="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pstate, papply, ploss, psec, pms, pcounts = run_training(
        torch, pong, pcfg, PONG_STEPS, 0, device)
    peak = torch.cuda.max_memory_allocated()
    want = {"megastep": PONG_STEPS, "raster": 2 * PONG_STEPS}
    if {k: pcounts[k] for k in want} != want:
        raise AssertionError(f"Pong-v0 CNN: launches {pcounts}, want {want}")
    if not bool(torch.isfinite(ploss).all()):
        raise AssertionError("Pong-v0 CNN: a loss is not finite")
    ring = pstate.replay
    ring_bytes = sum(x.numel() * x.element_size()
                     for x in (ring.obs, ring.next_obs))
    if ring_bytes != 2 * PONG_CFG["memory_size"] * 4 * 84 * 84 * 4:
        raise AssertionError(f"Pong-v0 ring holds {ring_bytes} bytes")

    # 5. cnn_apply on the card against the CPU, with cuDNN's TF32 default
    # (True) restored: the port must pin float32 itself
    x = ring.obs[:PONG_CFG["batch_size"]]
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = papply(pstate.params, x)
        left_alone = torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    want_q = papply(tree_map(lambda p: p.cpu(), pstate.params), x.cpu())
    if not left_alone:
        raise AssertionError("cnn_apply left cudnn.allow_tf32 switched off")
    np.testing.assert_allclose(got.cpu().numpy(), want_q.numpy(),
                               rtol=CNN_TOL, atol=CNN_TOL,
                               err_msg="cnn_apply: card against CPU")
    out["pong_cnn"] = {
        "id": "Pong-v0", "steps": PONG_STEPS, "B": PONG_CFG["num_envs"],
        "seconds": psec, "step_ms_median": statistics.median(pms),
        "ms_per_step": 1e3 * psec / PONG_STEPS, "launches": pcounts,
        "replay_device_bytes": ring_bytes,
        "peak_bytes_above_start": peak - base, "loss_finite": True,
        "ring_frames_nonzero": bool(ring.obs[:PONG_STEPS].sum() > 0),
        "cnn_card_vs_cpu_max_abs_err": float((got.cpu() - want_q).abs().max()),
        "cnn_tol": CNN_TOL, "cudnn_allow_tf32_during_check": True}
    launches = {k: counts[k] + pcounts[k] for k in ("megastep", "raster")}
    out.update(launches=launches, megastep_err=mega_err,
               seconds=time.perf_counter() - t0)
    del pstate, ring, x
    torch.cuda.empty_cache()
    emit(out)
    return launches, mega_err, table_i


def phase_train_profile(torch, table_i):
    """torch.profiler over TRAIN_PROFILE_STEPS Table I steps carried on
    from phase train: wall and device-busy ms a step, idle share, launches
    a step, and each layer of the step read from its `dqn.STAGES` range
    (near the end: a profiler slows what follows it). Also what a range
    costs the step when no profiler runs."""
    from torch.profiler import record_function

    from repro_torch.rl import dqn

    env, cfg, state, apply_fn = table_i
    step_fn = dqn.make_train_step(env, apply_fn, cfg, state.step.device)
    carry = [state]

    def step():
        carry[0] = step_fn(carry[0])[0]

    t0 = time.perf_counter()
    with uncounted():
        out = profile_window(torch, step, TRAIN_PROFILE_STEPS, dqn.STAGES)
    layers = out["ranges_ms"]
    out["outside_ranges_host_ms"] = out["wall_ms"] - sum(
        r["host_ms"] for r in layers.values())
    t1 = time.perf_counter()
    for _ in range(RANGE_COST_CALLS):
        with record_function(dqn.STAGES[0]):
            pass
    out["range_cost_us_profiler_off"] = (
        1e6 * (time.perf_counter() - t1) / RANGE_COST_CALLS)
    out["ranges_per_step"] = len(dqn.STAGES)
    emit({"phase": "train_profile", "seconds": time.perf_counter() - t0,
          "steps": TRAIN_PROFILE_STEPS, **out})
    return out


def phase_numbers(device, pools, vmap_pools, sync):
    import repro_torch
    from repro_torch import random as R

    t0 = time.perf_counter()
    key = R.PRNGKey(2, device)
    rows = []
    depth = {MULTITASK_ID: MULTITASK_STEPS,
             **{env_id: GRID_PX_STEPS for env_id in GRID_PX_IDS}}
    runs = [(env_id, pool) for env_id, pool in pools.items()]
    runs += [(env_id, pool) for env_id, pool in vmap_pools.items()]
    small = repro_torch.make_vec("CartPole-v1", B_SMALL, unroll=K, device=device)
    small.rollout(STEPS, key)
    runs.append(("CartPole-v1", small))
    for env_id, pool in runs:
        steps = depth.get(env_id, STEPS)
        sec = timed(lambda: pool.rollout(steps, key), TIMED_RUNS, sync)
        b = pool.num_envs
        rows.append({"id": env_id, "B": b, "steps": steps,
                     "backend": pool.backend, "unroll": pool.unroll,
                     "seconds_median": sec,
                     "env_steps_per_s": b * steps / sec})
    emit({"phase": "numbers", "seconds": time.perf_counter() - t0,
          "timed_runs": TIMED_RUNS, "clock":
          "host perf_counter around rollout + synchronize", "rows": rows})
    return {r["id"]: r for r in rows[:-1]}      # the main pools' rows


def chunk_ops(torch, pool, state, k, key, device):
    """One fused chunk's megastep operands from the pool's `state`, built as
    its step builds them: (core, spec, max_steps, (rows, keys, actions))."""
    from repro_torch import random as R
    from repro_torch.core.spaces import sample_batch
    from repro_torch.kernels.envstep.ops import _resolve, state_rows

    core, spec, max_steps, num_stack, _ = _resolve(pool.env)
    steps = torch.arange(1, k + 1, device=device)
    acts = sample_batch(pool.action_space, R.fold_in(key, steps),
                        pool.num_envs)     # (K, B), or (K, B, 1) if continuous
    acts = acts.reshape(k, pool.num_envs).to(torch.float32).contiguous()
    inner = state.inner.inner if num_stack else state.inner
    rows = state_rows(spec, max_steps, inner).contiguous()
    return core, spec, max_steps, (rows, state.key.contiguous(), acts)


def phase_render_check(torch, device, pools):
    """Both kernels against their plain versions at the render path's own
    shapes: per render id (the classic ones and Maze-v0), a K = 1 megastep
    at B = 65,536 from a state 16 steps into the render pool's rollout, and
    the raster of the frames that step's new state renders to."""
    from repro_torch import random as R
    from repro_torch.core.spaces import sample_batch
    from repro_torch.kernels.envstep import megastep_cuda

    t0 = time.perf_counter()
    key = R.PRNGKey(4, device)
    rows, mega_err, raster_err = [], 0.0, 0.0
    with uncounted():
        for env_id, pool in pools.items():
            h = pool.xla()
            ps = h.init(key)
            for t in range(16):
                k = R.fold_in(key, t)
                ps, _ = h.step(ps, sample_batch(pool.action_space, k,
                                                pool.num_envs), k)
            core, spec, max_steps, ops = chunk_ops(
                torch, pool, ps.env_state, 1, R.fold_in(key, 99), device)
            grid = spec.name in GRID     # bit for bit
            got = megastep_cuda(spec.kernel_id, *ops, max_steps=max_steps)
            m_err = compare(torch, got, plain_megastep(
                core, spec, ops, max_steps),
                f"{env_id} render-path step B={pool.num_envs} K=1",
                EXACT_ALL if grid else ("done", "truncated"))
            base = core.unwrapped
            segs, intens = base.scene(
                spec.unflatten(got[0][:spec.state_size]))
            r_err, frames = raster_check(
                torch, segs.contiguous(), intens.contiguous(),
                *base.frame_shape, f"{env_id} render-path frames")
            if not bool(frames.max() > 0.5):
                raise AssertionError(f"{env_id}: render-path frames blank")
            mega_err, raster_err = max(mega_err, m_err), max(raster_err, r_err)
            rows.append({"id": env_id, "B": pool.num_envs, "K": 1,
                         "frames": intens.shape[0], "S": intens.shape[1],
                         "megastep_max_abs_err": m_err,
                         "raster_max_abs_err": r_err})
    emit({"phase": "render_check", "seconds": time.perf_counter() - t0,
          "megastep_rtol": RTOL, "megastep_atol": ATOL,
          "raster": "bit for bit", "rows": rows})
    return mega_err, raster_err


def chunk_memory(torch, pool, device):
    """Device memory of one fused chunk (`step_many` over `unroll` steps)
    from the pool's reset: the peak allocated during the chunk, and that
    peak above what was allocated before it. Uses only the pool's public
    surface, so it measures an earlier tree's package as well."""
    from repro_torch import random as R
    from repro_torch.core.spaces import sample_batch

    h = pool.xla()
    key = R.PRNGKey(5, device)
    ps = h.init(key)
    steps = torch.arange(1, pool.unroll + 1, device=device)
    acts = sample_batch(pool.action_space, R.fold_in(key, steps),
                        pool.num_envs)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = h.step_many(ps, acts)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    return {"id": pool.env.name, "B": pool.num_envs, "K": pool.unroll,
            "peak_bytes": peak, "chunk_bytes_above_start": peak - before}


def phase_bodies(torch, device, pools, sync, numbers, bw, flops):
    """Every fused id on a real chunk of its main path (its pool's B and K,
    from the pool's reset): the megastep against its plain twin (the grid
    bodies bit for bit, the arcade rewards exact), both timed; the resets;
    the bound over this chunk's bytes and operations; the chunk's split
    (the whole chunk from phase numbers, the kernel, the action sampling);
    and the peak device memory of a Maze-v0 chunk."""
    from repro_torch import random as R
    from repro_torch.core.spaces import sample_batch
    from repro_torch.kernels.envstep import megastep_cuda

    t0 = time.perf_counter()
    key = R.PRNGKey(3, device)
    bodies, worst = {}, 0.0
    for env_id in IDS + PIXEL_IDS + GRID_IDS:
        pool = pools[env_id]
        b, k = pool.num_envs, pool.unroll
        state = pool.xla().init(R.PRNGKey(0, device)).env_state
        core, spec, max_steps, ops = chunk_ops(torch, pool, state, k, key,
                                               device)
        exact = EXACT_ALL if spec.name in GRID else (
            ("reward", "done", "truncated") if env_id in PIXEL_IDS
            else ("done", "truncated"))
        with uncounted():
            got = megastep_cuda(spec.kernel_id, *ops, max_steps=max_steps)
            err = compare(torch, got, plain_megastep(core, spec, ops,
                                                     max_steps),
                          f"{env_id} main-path chunk B={b} K={k}", exact)
            ms = event_ms(torch, lambda: megastep_cuda(
                spec.kernel_id, *ops, max_steps=max_steps), 20, warmup=3)
            plain_ms = event_ms(torch, lambda: plain_megastep(
                core, spec, ops, max_steps), 3, warmup=0)
        worst = max(worst, err)
        resets = int(got[5].sum())
        sp = spec.state_size + (0 if max_steps is None else 1)
        nbytes = megastep_bytes(b, k, sp, spec.obs_size)
        int_ops, float_ops = megastep_ops(spec.name, b, k, resets)
        bound_ms, bound_by = bound(nbytes, float_ops, bw, flops, int_ops)
        steps = torch.arange(1, k + 1, device=device)
        bodies[spec.name] = {
            "id": env_id, "body": spec.name, "B": b, "K": k, "S": sp,
            "O": spec.obs_size, "max_abs_err": err, "resets": resets,
            "ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
            "int_ops": int_ops, "float_ops": float_ops,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "rollout_chunk_ms": 1e3 * numbers[env_id]["seconds_median"]
            / (STEPS // k),
            "action_sampling_ms": 1e3 * timed(
                lambda: sample_batch(pool.action_space, R.fold_in(key, steps),
                                     b), 5, sync)}
    memory = chunk_memory(torch, pools[GRID_RENDER_ID], device)
    emit({"phase": "bodies", "seconds": time.perf_counter() - t0,
          "bodies": list(bodies.values()), "chunk_memory": memory,
          "rates": {"bytes_per_s": bw, "fp32_flops": flops,
                    "int32_ops": INT32_PER_FP32_FLOP * flops},
          "clock": "kernel: CUDA events over 20 launches, plain over 3; "
                   "rollout chunk: phase numbers' median over chunks; "
                   "sampling: host perf_counter + synchronize, median of 5"})
    return bodies, worst, memory


def phase_pixel_split(torch, device, env_id, pool, sync, numbers, bw, flops):
    """Both kernels against their plain versions on a real chunk of a pixel
    id, then the per-chunk cost of the raster and the frame stack."""
    from repro_torch import random as R
    from repro_torch.core.spaces import sample_batch
    from repro_torch.kernels.envstep import megastep_cuda
    from repro_torch.kernels.envstep.ops import _render_obs_rows, _stack_frames
    from repro_torch.kernels.raster import rasterize_cuda

    t0 = time.perf_counter()
    key = R.PRNGKey(3, device)
    state = pool.xla().init(R.PRNGKey(0, device)).env_state
    core, spec, max_steps, ops = chunk_ops(torch, pool, state, K_PIXEL, key,
                                           device)
    base = core.unwrapped
    h, w = base.frame_shape
    steps = torch.arange(1, K_PIXEL + 1, device=device)

    def scenes(obs_rows):
        segs, intens = base.scene(spec.unflatten(obs_rows))
        return (segs.reshape(-1, *segs.shape[-2:]).contiguous(),
                intens.reshape(-1, intens.shape[-1]).contiguous())

    with uncounted():
        got = megastep_cuda(spec.kernel_id, *ops, max_steps=max_steps)
        mega_err = compare(torch, got, plain_megastep(core, spec, ops,
                                                      max_steps),
                           f"{env_id} main-path chunk B={B_PIXEL}",
                           ("reward", "done", "truncated"))
        # the terminal_obs rows' scenes and the obs rows' (the fresh state's
        # where a lane reset)
        pre_scene, post_scene = scenes(got[3]), scenes(got[2])
        raster_err = 0.0
        for what, sc in (("stepped", pre_scene), ("post-reset", post_scene)):
            raster_err = max(raster_err, raster_check(
                torch, *sc, h, w, f"{env_id} chunk {what} scenes")[0])
        raster = raster_times(torch, *pre_scene, h, w, bw, flops)
        two_raster_ms = event_ms(torch, lambda: [
            rasterize_cuda(*sc, h, w) for sc in (pre_scene, post_scene)], 10)
        pre = _render_obs_rows(core, spec, got[3], "cuda")
        post = _render_obs_rows(core, spec, got[2], "cuda")
    done = got[5].to(torch.bool)
    frames = state.inner.frames
    select_ms = 1e3 * timed(lambda: _stack_frames(frames, pre, post, done),
                            5, sync)
    sampling_ms = 1e3 * timed(
        lambda: sample_batch(pool.action_space, R.fold_in(key, steps),
                             B_PIXEL), 5, sync)
    chunk_ms = 1e3 * numbers[env_id]["seconds_median"] / (STEPS // K_PIXEL)
    emit({"phase": "split", "seconds": time.perf_counter() - t0,
          "id": env_id, "B": B_PIXEL, "K": K_PIXEL,
          "max_abs_err_vs_plain": {"megastep": mega_err, "raster": raster_err},
          "resets": int(got[5].sum()),
          "per_chunk_ms": {"rollout_chunk": chunk_ms,
                           "two_raster_launches": two_raster_ms,
                           "frame_stack_select": select_ms,
                           "action_sampling": sampling_ms},
          "raster_stepped_scenes": raster,
          "clock": "kernels: CUDA events (the two raster launches over 10 "
                   "pairs); others: host perf_counter + synchronize, median "
                   "of 5"})
    return {"raster": raster, "megastep_err": mega_err,
            "raster_err": raster_err, "frames": pre_scene[1].shape[0],
            "S": pre_scene[1].shape[1]}


# -- the LM serving path (flash attention) --------------------------------------

#: head layouts of the two LM configs the port serves: (query heads, KV
#: heads, head dim)
YI_HEADS, DANUBE_HEADS = (32, 4, 128), (32, 8, 80)
#: the JAX package's attention tolerances (tests/test_kernels.py):
#: test_flash_attention_sweep (f32) and test_flash_attention_bf16
ATTN_TOL = {"float32": 3e-5, "bfloat16": 5e-2}
#: bf16 limits inside that tolerance. The kernel and attention_ref both
#: compute in f32 and round once to bf16, so their f32 values differ far
#: below a bf16 ulp and the rounded outputs by at most one ulp of the larger:
#: every error within BF16_ULPS ulps of max(|got|, |want|) plus
#: BF16_FLOOR of the largest |want| (for outputs near 0, where the f32
#: sums' own rounding exceeds the ulp), and bits differing in at most
#: BF16_BITS_SHARE of the outputs. A fault of the bf16 load, conversion or
#: store, or a dropped K tile, moves most outputs of a row by many ulps.
BF16_ULPS, BF16_FLOOR, BF16_BITS_SHARE = 2, 1e-4, 0.01
#: (case, heads, B, Lq, Lk, causal, window, q_offset); each runs in bf16
#: and f32. The first is the main path's shape: a 2,048-token prompt
#: prefilled against Yi-6B's 4,096-slot cache
ATTN_CASES = (
    ("causal over a full cache", YI_HEADS, 1, 2048, 4096, True, 0, 0),
    ("causal over a full cache", DANUBE_HEADS, 1, 2048, 4096, True, 0, 0),
    ("ragged prompt", YI_HEADS, 1, 37, 4096, True, 0, 0),
    ("ragged prompt", DANUBE_HEADS, 1, 37, 4096, True, 0, 0),
    ("decode", YI_HEADS, 1, 1, 4096, True, 0, 3000),
    ("decode", DANUBE_HEADS, 1, 1, 4096, True, 0, 3000),
    ("window", DANUBE_HEADS, 1, 4608, 4608, True, 4096, 0),
    ("non-causal", YI_HEADS, 1, 1024, 1024, False, 0, 0),
    ("non-causal", DANUBE_HEADS, 1, 1024, 1024, False, 0, 0),
    ("B = 2, offset prompt", YI_HEADS, 2, 333, 4096, True, 0, 100),
)
#: the serving run: Yi-6B at full width and depth through ServeEngine
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_REQUESTS, SERVE_NEW = 8, 4096, 16, 64
PROMPT_LENS = (128, 2048)
LM_SEED = 0
#: prompt lengths of the decode-matches-forward invariant and of the
#: prefill whose layers 0 and 31 feed the kernel check
INVARIANT_L, REAL_PROMPT = 1000, 2048
#: tolerances of the decode-matches-forward invariant on Yi-6B's logits.
#: In f32 (params upcast from the engine's bf16 copy) the JAX package's own,
#: elementwise (tests/test_models.py::test_decode_matches_forward). In bf16
#: the two paths round differently wherever cuBLAS orders the sums of an
#: L-row and an (L+1)-row product differently, and 32 layers carry those
#: roundings to every logit as noise: the bf16 bound is on the error of the
#: logit vector as a whole, ||decode - forward|| <= 5e-2 ||forward|| (the
#: JAX package's bf16 attention tolerance, tests/test_kernels.py), and the
#: same against the decode logits through the plain attention
F32_LOGIT_TOL, BF16_LOGIT_REL = 2e-3, 5e-2
#: h2o-danube-1.8b at full width, cut to 4 of its 24 layers: one prompt
#: past its 4,096-token window, then per-slot decode steps
DANUBE_LAYERS, DANUBE_PROMPT, DANUBE_DECODES = 4, 4608, 16
#: decode ticks in the profiled window
PROFILE_TICKS = 5


def attention_work(b, heads, lq, lk, causal, window, q_offset, itemsize):
    """(live query-key pairs, bytes, flops) of one attention call: each
    row's visible keys counted, Q and O and the live K and V moved once,
    4·D flops a live pair (q·k and p·v)."""
    import numpy as np

    hq, hkv, d = heads
    qpos = q_offset + np.arange(lq, dtype=np.int64)
    hi = np.minimum(lk, qpos + 1) if causal else np.full(lq, lk)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else np.zeros(lq, np.int64)
    pairs = int(np.maximum(hi - lo, 0).sum())
    live_keys = max(0, int(hi.max()) - int(lo.min()))
    moved = itemsize * d * b * (2 * hq * lq + 2 * hkv * live_keys)
    return pairs * b * hq, moved, 4 * d * pairs * b * hq


def attention_inputs(torch, heads, b, lq, lk, dtype, seed, device):
    hq, hkv, d = heads
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda h, l: torch.randn((b, h, l, d), generator=g, device=device).to(dtype)
    return mk(hq, lq), mk(hkv, lk), mk(hkv, lk)


def attention_check(torch, q, k, v, what, **kw):
    """The kernel against the plain version on one input: max abs error,
    the share of outputs whose bits differ and, in bf16, the worst error
    over its BF16_ULPS limit. Raises past the JAX package's tolerance for
    the dtype and, in bf16, past either of BF16_BITS_SHARE and the ulp
    limit."""
    from repro_torch.kernels.attention import attention_ref, flash_attention_cuda

    got = flash_attention_cuda(q, k, v, **kw)
    want = attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = ATTN_TOL[str(q.dtype).split(".")[-1]]
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"flash {what}: {got.shape} {got.dtype}, want "
                             f"{want.shape} {want.dtype}")
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"flash {what}: {m}")
    bits = torch.int16 if q.dtype == torch.bfloat16 else torch.int32
    out = {"max_abs_err": float((got.float() - want.float()).abs().max()),
           "bits_differ": float((got.view(bits) != want.view(bits)).float().mean())}
    if q.dtype == torch.bfloat16:
        g, w = got.float(), want.float()
        # a bf16 value in [2^(e-1), 2^e) has an ulp of 2^(e-8)
        mag = torch.maximum(g.abs(), w.abs())
        ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
        limit = BF16_ULPS * ulp + BF16_FLOOR * float(w.abs().max())
        out["err_over_ulp_limit"] = float(((g - w).abs() / limit).max())
        if out["bits_differ"] > BF16_BITS_SHARE or out["err_over_ulp_limit"] > 1:
            raise AssertionError(
                f"flash {what}: {out}; bf16 limits: bits differ in at most "
                f"{BF16_BITS_SHARE} of outputs, errors within {BF16_ULPS} "
                f"ulps + {BF16_FLOOR} max|want|")
    return out


def phase_attention(torch, device, bw, fp32_flops, bf16_flops):
    """The CUDA flash attention against attention_ref at the LM path's
    shapes; kernel, plain and SDPA times and the bound at the main path's."""
    import torch.nn.functional as F

    from repro_torch.kernels.attention import attention_ref, flash_attention_cuda

    t0 = time.perf_counter()
    cases, worst, main = [], 0.0, None
    with uncounted():
        for i, (what, heads, b, lq, lk, causal, window, q_offset) in enumerate(
                ATTN_CASES):
            for dtype in (torch.bfloat16, torch.float32):
                name = str(dtype).split(".")[-1]
                q, k, v = attention_inputs(torch, heads, b, lq, lk, dtype, i,
                                           device)
                kw = dict(causal=causal, window=window, q_offset=q_offset)
                checked = attention_check(torch, q, k, v, what, **kw)
                worst = max(worst, checked["max_abs_err"])
                case = {"case": what, "dtype": name, "heads": heads, "B": b,
                        "Lq": lq, "Lk": lk, "causal": causal,
                        "window": window, "q_offset": q_offset,
                        "tol": ATTN_TOL[name], **checked}
                if i == 0 or (what == "window" and dtype == torch.bfloat16):
                    pairs, moved, ops = attention_work(
                        b, heads, lq, lk, causal, window, q_offset,
                        q.element_size())
                    rate = bf16_flops if dtype == torch.bfloat16 else fp32_flops
                    bound_ms, bound_by = bound(moved, ops, bw, rate)
                    case.update(
                        live_pairs=pairs, bytes=moved, flops=ops,
                        bound_ms=bound_ms, bound_by=bound_by,
                        ms=event_ms(torch, lambda: flash_attention_cuda(
                            q, k, v, **kw), 20),
                        plain_ms=event_ms(torch, lambda: attention_ref(
                            q, k, v, **kw), 3, warmup=1))
                    if causal and q_offset == 0 and not window:
                        # is_causal is top-left aligned: key j <= row i, the
                        # same mask as q_offset 0
                        sdpa = lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=True, enable_gqa=True)
                        case["library"] = ("torch.nn.functional."
                                           "scaled_dot_product_attention")
                        case["library_ms"] = event_ms(torch, sdpa, 20)
                        case["library_max_abs_err"] = float(
                            (sdpa().float() - attention_ref(q, k, v, **kw)
                             .float()).abs().max())
                    if i == 0 and dtype == torch.bfloat16:
                        main = case
                cases.append(case)
                del q, k, v
    torch.cuda.empty_cache()
    emit({"phase": "attention", "seconds": time.perf_counter() - t0,
          "cases": cases, "clock": "CUDA events: kernel and SDPA over 20 "
          "launches, plain over 3", "rates": {"bytes_per_s": bw,
                                              "bf16_flops": bf16_flops,
                                              "fp32_flops": fp32_flops}})
    return worst, main


@contextlib.contextmanager
def captured_attention(layers, backend="auto"):
    """Record the (q, k, v, kwargs) of the LM's attention calls numbered in
    `layers` (0 = the first call), and route every call to `backend`."""
    import torch

    from repro_torch.kernels.attention import ops

    original, seen = ops.attention, {}
    calls = [0]

    def spy(q, k, v, **kw):
        if calls[0] in layers:
            seen[calls[0]] = tuple(x.clone(memory_format=torch.contiguous_format)
                                   for x in (q, k, v)) + (dict(kw),)
        calls[0] += 1
        return original(q, k, v, **{**kw, "backend": backend})

    ops.attention = spy
    try:
        yield seen
    finally:
        ops.attention = original


def profile_window(torch, fn, n, ranges=()):
    """torch.profiler over n calls of fn (after one warm call): wall ms a
    call, device-busy ms a call (the sum of the kernels' device time), the
    idle share, and the five costliest kernels. Device fields are None
    when the trace holds no device time. For each name in `ranges` (the
    `record_function` ranges inside fn), its host ms a call and the device
    ms of the kernels launched inside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / n
    # kernel rows only: an op's row repeats its kernels' device time, and so
    # does a range's device-side row
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in ranges]
    rows = [(e.key, e.self_device_time_total / 1e3 / n) for e in kernels]
    busy = sum(ms for _, ms in rows)
    top = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])[:5]
    out = {"calls": n, "wall_ms": wall,
           "kernel_launches": sum(e.count for e in kernels) / n,
           "device_busy_ms": busy if busy > 0 else None,
           "idle_share": 1 - busy / wall if busy > 0 else None,
           "top_kernels_ms": top,
           "clock": "host clock around the window (profiler on); device "
                    "time from the trace"}
    if ranges:
        layers = {name: {"host_ms": 0.0, "device_ms": 0.0} for name in ranges}
        for e in prof.events():
            if e.name in layers and e.device_type == DeviceType.CPU:
                layers[e.name]["host_ms"] += e.cpu_time_total / 1e3 / n
                layers[e.name]["device_ms"] += e.device_time_total / 1e3 / n
        out["ranges_ms"] = layers
    return out


def decode_vs_forward(lm, cfg, params, toks, backend):
    """(decode_step logits at L after prefill(L), forward(L + 1)'s last
    logits), every attention routed to `backend`."""
    l = toks.shape[1] - 1
    with captured_attention(set(), backend):
        hidden, _ = lm.forward(cfg, params, {"tokens": toks})
        ref = lm.logits_for(cfg, params, hidden[:, -1:])[:, 0]
        _, caches = lm.prefill(cfg, params, {"tokens": toks[:, :l]},
                               SERVE_MAX_SEQ)
        got, _ = lm.decode_step(cfg, params, caches, toks[:, l:], l)
    return got, ref


def logit_errors(got, ref):
    d = (got - ref).float()
    return {"max_abs": float(d.abs().max()),
            "rel_l2": float(d.norm() / ref.float().norm())}


def lm_prompts(vocab):
    import numpy as np

    rng = np.random.default_rng(LM_SEED)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, SERVE_REQUESTS)
    return [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lens]


def serve_requests(torch, engine, prompts):
    """The main path: every prompt through engine.step() until all are
    served. Returns (requests, seconds, first-token seconds per request,
    per-tick (seconds, admitted))."""
    from repro_torch.serving.engine import Request

    reqs = [Request(rid=i, prompt=p, max_new_tokens=SERVE_NEW)
            for i, p in enumerate(prompts)]
    table = engine.slots_table
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    first, ticks, last = {}, [], t0
    while table.queued_count or table.active_count:
        admitted = table.admitted
        engine.step()          # ends in a host copy of the tokens: a sync
        now = time.perf_counter()
        ticks.append((now - last, table.admitted - admitted))
        last = now
        for r in reqs:
            if r.output and r.rid not in first:
                first[r.rid] = now - t0
        if len(ticks) > SERVE_REQUESTS * (SERVE_NEW + 4):
            raise AssertionError("the engine did not drain its queue")
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0, first, ticks


def phase_lm(torch, device):
    """Yi-6B at full width and depth through ServeEngine (the main path of
    this slice), the decode-matches-forward invariant through the kernel,
    the kernel on real layer inputs; then h2o-danube-1.8b at full width
    through the ring path."""
    import dataclasses
    import gc

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServeEngine

    t0 = time.perf_counter()
    out = {"phase": "lm"}
    cfg = get_config("yi-6b")
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    params = lm.init_params(cfg, gen, device)
    torch.cuda.synchronize()
    out["yi_init_s"] = time.perf_counter() - t0
    out["yi_params"] = sum(x.numel() for x in lm.tree_leaves(params))
    engine = ServeEngine(cfg, params, slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                         device=device)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    eparams = engine.params
    out["engine_params_dtype"] = str(eparams["lm_head"].dtype)
    prompts = lm_prompts(cfg.vocab_size)

    with uncounted():  # warm cuBLAS and the kernel's library
        warm = torch.from_numpy(prompts[0][:PROMPT_LENS[0]])[None].to(device)
        logits, caches = lm.prefill(cfg, eparams, {"tokens": warm},
                                    SERVE_MAX_SEQ)
        lm.decode_step(cfg, eparams, caches, logits.argmax(-1).to(torch.int32),
                       torch.tensor([warm.shape[1]], device=device))
        del caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    reqs, seconds, first, ticks = serve_requests(torch, engine, prompts)
    launches = read_counts()
    want = {"megastep": 0, "raster": 0,
            "flash": SERVE_REQUESTS * cfg.num_layers}
    if launches != want:
        raise AssertionError(f"yi-6b serving: launches {launches}, want {want}")
    for r in reqs:
        if len(r.output) != SERVE_NEW or not all(
                0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.rid}: {len(r.output)} tokens, "
                                 f"want {SERVE_NEW} in [0, {cfg.vocab_size})")
    ttft = sorted(first.values())
    decode_ticks = [s for s, n in ticks if n == 0]
    generated = sum(len(r.output) for r in reqs)
    out["serve"] = {
        "arch": cfg.name, "slots": SERVE_SLOTS, "max_seq": SERVE_MAX_SEQ,
        "requests": SERVE_REQUESTS, "max_new_tokens": SERVE_NEW,
        "prompt_tokens": int(sum(len(p) for p in prompts)),
        "prompt_lens": [len(p) for p in prompts],
        "seconds": seconds, "generated_tokens": generated,
        "tokens_per_s": generated / seconds,
        "ttft_s_median": statistics.median(ttft), "ttft_s_max": ttft[-1],
        "ticks": len(ticks), "decode_tick_ms_median":
            1e3 * statistics.median(decode_ticks) if decode_ticks else None,
        "admit_ticks_s": sum(s for s, n in ticks if n),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "stats": engine.stats(),
        "clock": "host clock; each tick ends in the tokens' host copy, so "
                 "a first token is stamped at the end of its tick"}
    del engine.state
    gc.collect()
    torch.cuda.empty_cache()

    errs = []
    with uncounted():
        # tests/test_models.py::test_decode_matches_forward, through the
        # kernel: prefill(L) + decode_step(L) against forward(L + 1), in
        # bf16 through the kernel and the plain attention, and in f32
        toks = torch.from_numpy(np.resize(prompts[1], INVARIANT_L + 1)).to(
            device)[None].long()
        runs = {"bfloat16 kernel": (cfg, eparams, "auto"),
                "bfloat16 plain": (cfg, eparams, "torch")}
        logits = {}
        for what, (c, p, backend) in runs.items():
            logits[what] = decode_vs_forward(lm, c, p, toks, backend)
        p32 = lm.tree_map(lambda x: x.float(), eparams)
        logits["float32 kernel"] = decode_vs_forward(
            lm, dataclasses.replace(cfg, dtype="float32"), p32, toks, "auto")
        del p32
        inv = {what: logit_errors(*pair) for what, pair in logits.items()}
        inv["bfloat16 kernel against plain, decode"] = logit_errors(
            logits["bfloat16 kernel"][0], logits["bfloat16 plain"][0])
        out["decode_matches_forward"] = {
            "L": INVARIANT_L, "f32_tol": F32_LOGIT_TOL,
            "bf16_rel_l2_tol": BF16_LOGIT_REL,
            "max_abs_logit": float(logits["bfloat16 kernel"][1].abs().max()),
            **inv}
        emit({"check": "decode_matches_forward",
              **out["decode_matches_forward"]})
        got, ref = logits["float32 kernel"]
        torch.testing.assert_close(
            got, ref, rtol=F32_LOGIT_TOL, atol=F32_LOGIT_TOL,
            msg=lambda m: f"yi-6b f32 decode != forward: {m}")
        for what in ("bfloat16 kernel", "bfloat16 kernel against plain, decode"):
            if not inv[what]["rel_l2"] <= BF16_LOGIT_REL:
                raise AssertionError(f"yi-6b decode != forward ({what}): "
                                     f"{inv[what]}")
        del logits

        # the kernel on the real q, k and v of layers 0 and 31 of one
        # 2,048-token prefill
        toks = torch.from_numpy(np.resize(prompts[2], REAL_PROMPT)).to(device)[None]
        with captured_attention({0, cfg.num_layers - 1}) as seen:
            lm.prefill(cfg, eparams, {"tokens": toks}, SERVE_MAX_SEQ)
        real = {}
        for layer, (q, k, v, kw) in sorted(seen.items()):
            checked = attention_check(torch, q, k, v,
                                      f"yi-6b layer {layer}", **kw)
            real[f"yi-6b layer {layer}"] = {
                "q": list(q.shape), "k": list(k.shape), **kw, **checked}
            errs.append(checked["max_abs_err"])
        del seen, eparams, engine
    gc.collect()
    torch.cuda.empty_cache()

    # h2o-danube-1.8b at full width, 4 layers: a 4,608-token prompt through
    # the ring (SWA) prefill, then per-slot decode steps on the ring
    t1 = time.perf_counter()
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"),
                              segments=((("swa",), DANUBE_LAYERS),))
    params = lm.compute_params(cfg, lm.init_params(
        cfg, torch.Generator(device=device).manual_seed(LM_SEED), device))
    rng = np.random.default_rng(LM_SEED + 1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, DANUBE_PROMPT))).to(device)
    reset_counts()
    with captured_attention({0, DANUBE_LAYERS - 1}) as seen:
        logits, caches = lm.prefill(cfg, params, {"tokens": toks},
                                    2 * DANUBE_PROMPT)
    prefill_launches = read_counts()
    want = {"megastep": 0, "raster": 0, "flash": DANUBE_LAYERS}
    if prefill_launches != want:
        raise AssertionError(f"danube ring prefill: launches "
                             f"{prefill_launches}, want {want}")
    if caches[0]["b0"].k.shape[3] != cfg.window:
        raise AssertionError(f"danube cache {tuple(caches[0]['b0'].k.shape)}"
                             f" is not a {cfg.window}-slot ring")
    with uncounted():
        for layer, (q, k, v, kw) in sorted(seen.items()):
            checked = attention_check(torch, q, k, v,
                                      f"danube layer {layer}", **kw)
            real[f"h2o-danube-1.8b layer {layer}"] = {
                "q": list(q.shape), "k": list(k.shape), **kw, **checked}
            errs.append(checked["max_abs_err"])
        del seen
    reset_counts()
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    pos = torch.tensor([DANUBE_PROMPT], dtype=torch.int32, device=device)
    scalar_err = None
    for step in range(DANUBE_DECODES):
        lg, caches = lm.decode_step(cfg, params, caches, tok, pos)
        if step == 0:
            # the scalar-position ring decode writes the same slot with the
            # same k and v, and must give the same logits
            with uncounted():
                lg_scalar, _ = lm.decode_step(cfg, params, caches, tok,
                                              DANUBE_PROMPT)
            scalar_err = float((lg - lg_scalar).abs().max())
            torch.testing.assert_close(lg, lg_scalar, rtol=0, atol=0)
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"danube decode step {step}: non-finite logits")
        tok, pos = lg.argmax(-1).to(torch.int32)[:, None], pos + 1
    if read_counts() != {"megastep": 0, "raster": 0, "flash": 0}:
        raise AssertionError(f"danube per-slot decode launched {read_counts()}")
    torch.cuda.synchronize()
    out["danube"] = {"layers": DANUBE_LAYERS, "prompt": DANUBE_PROMPT,
                     "window": cfg.window, "prefill_launches": prefill_launches,
                     "decode_steps": DANUBE_DECODES,
                     "scalar_vs_per_slot_max_abs_err": scalar_err,
                     "seconds": time.perf_counter() - t1}
    out["real_layer_checks"] = real
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return max(errs), out


def phase_lm_profile(torch, device):
    """Where the serving run's time goes, on a fresh Yi-6B engine: a
    profiler window over decode ticks (every slot decodes whether active or
    not, so the zeroed caches cost what full ones do) and over one
    2,048-token prefill. Last of the phases: a profiler leaves the CUDA
    launches of the process slower after it stops."""
    import gc

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServeEngine

    t0 = time.perf_counter()
    cfg = get_config("yi-6b")
    engine = ServeEngine(cfg, lm.init_params(
        cfg, torch.Generator(device=device).manual_seed(LM_SEED), device),
        slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, device=device)
    gc.collect()
    toks = torch.from_numpy(np.resize(lm_prompts(cfg.vocab_size)[2],
                                      REAL_PROMPT)).to(device)[None]
    with uncounted():
        out = {"decode_tick": profile_window(torch, lambda: engine._decode(
                   engine.params, engine.state), PROFILE_TICKS),
               "prefill_2048": profile_window(torch, lambda: lm.prefill(
                   cfg, engine.params, {"tokens": toks}, SERVE_MAX_SEQ), 1)}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "lm_profile", "seconds": time.perf_counter() - t0, **out})
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside the repository)

    device = torch.device("cuda")
    sync = torch.cuda.synchronize
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name, smi = phase_device(torch)
    bw, flops, bf16_flops = card_row(name)
    phase_build()
    flash_err, flash = phase_attention(torch, device, bw, flops, bf16_flops)
    lm_err, lm_out = phase_lm(torch, device)
    flash_err = max(flash_err, lm_err)
    mega_err = phase_kernel(torch, device)
    raster_err, grid_raster = phase_raster(torch, device, bw, flops)
    pools, vmap_pools, render_pools, launches = phase_main(torch, device, sync)
    errs = phase_render_check(torch, device, render_pools)
    mega_err, raster_err = max(mega_err, errs[0]), max(raster_err, errs[1])
    del render_pools
    phase_parity(torch, device)
    phase_golden(device)
    train_launches, train_err, table_i = phase_train(torch, device)
    mega_err = max(mega_err, train_err)
    numbers = phase_numbers(device, pools, vmap_pools, sync)
    del vmap_pools
    bodies, bodies_err, memory = phase_bodies(torch, device, pools, sync,
                                              numbers, bw, flops)
    mega_err = max(mega_err, bodies_err)
    pixel = {}
    for env_id in PIXEL_IDS:
        pixel[env_id] = phase_pixel_split(torch, device, env_id, pools[env_id],
                                          sync, numbers, bw, flops)
        mega_err = max(mega_err, pixel[env_id]["megastep_err"])
        raster_err = max(raster_err, pixel[env_id]["raster_err"])
    del pools
    phase_train_profile(torch, table_i)
    phase_lm_profile(torch, device)

    cartpole = bodies["CartPole"]
    pong = pixel["Pong-v0"]
    emit({"kernels": [{
        "name": "megastep",
        "route": "cuda",
        "source": "src/repro_torch/csrc/megastep.cu",
        "replaces": "src/repro/kernels/envstep/megastep.py:80",
        "launches": launches["megastep"] + train_launches["megastep"],
        "launches_per_path": {"env": launches["megastep"],
                              "train": train_launches["megastep"]},
        "max_abs_err": mega_err,
        "ms": cartpole["ms"],
        "plain_ms": cartpole["plain_ms"],
        "bound_ms": cartpole["bound_ms"],
        "bound_by": cartpole["bound_by"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes it",
        "shape": {k: cartpole[k] for k in ("id", "B", "K", "bytes", "int_ops",
                                           "float_ops", "resets")},
        "bodies": {n: {k: b[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "bytes", "int_ops",
                                         "resets")}
                   for n, b in bodies.items()},
        "maze_chunk_memory": memory,
        "card": smi,
    }, {
        "name": "raster",
        "route": "cuda",
        "source": "src/repro_torch/csrc/raster.cu",
        "replaces": "src/repro/kernels/raster/raster.py:57",
        "launches": launches["raster"] + train_launches["raster"],
        "launches_per_path": {"env": launches["raster"],
                              "train": train_launches["raster"]},
        "max_abs_err": raster_err,
        "ms": pong["raster"]["ms"],
        "plain_ms": pong["raster"]["plain_ms"],
        "bound_ms": pong["raster"]["bound_ms"],
        "bound_by": pong["raster"]["bound_by"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes it",
        "shape": {"id": "Pong-v0", "frames": pong["frames"], "S": pong["S"],
                  "H": 84, "W": 84,
                  **{k: pong["raster"][k] for k in (
                      "live_segments", "covered_pairs", "bytes", "ops",
                      "ops_all_pairs")}},
        "maze_scenes": {"frames": GRID_FRAMES, "S": 64, **grid_raster},
        "card": smi,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash.cu",
        "replaces": "src/repro/kernels/attention/flash.py:84",
        "launches": lm_out["serve"]["launches"]["flash"],
        "max_abs_err": flash_err,
        "ms": flash["ms"],
        "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
        "library": flash["library"],
        "shape": {k: flash[k] for k in ("case", "dtype", "heads", "B", "Lq",
                                        "Lk", "causal", "live_pairs", "bytes",
                                        "flops")},
        "card": smi,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
