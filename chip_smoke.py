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
           (32/4, D 128), h2o-danube-1.8b's (32/8, D 80), MiniCPM3-4B's
           (40/40, D 96, Dv 64: MLA's naive form), OLMoE-1B-7B's (16/16,
           D 128) and granite-moe-1b-a400m's (16/8, D 64): a 2,048-token
           prompt over a 4,096-slot cache, a ragged 37-token prompt, a
           decode row at position 3,000, Danube's 4,096 window over 4,608
           tokens, non-causal 1,024², B = 2, and Danube's training forward
           (B 4, 2,048 tokens); max error, the share of outputs whose bits
           differ, and at Yi's, MiniCPM3's, Whisper's and Danube's training
           shapes kernel, plain and SDPA times and the bound
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
  mla      MiniCPM3-4B (MLA) at full width and depth (random params from a
           seed): lm.prefill of 4 prompts of 2,048 tokens into a 4,096-slot
           cache, then 64 greedy lm.decode_step calls at a scalar position
           (the engine cannot serve MLA), counts set to 0 just before and
           read just after (62 layers × 65 calls: 4,030 flash launches);
           tokens/s, the prefill's seconds, a decode step's ms, peak
           memory; prefill + decode against forward through the kernel;
           the kernel on the real q, k and v of layers 0 and 61
  absorbed MLA's absorbed form: the (288, 256) flash instantiation (one
           KV head, 40 query heads a tile) against attention_ref in bf16
           and f32 at MiniCPM3-4B's heads (a 2,048-token prompt over 4,096
           slots, a ragged 37-token prompt, a decode row at 3,000), with
           kernel, plain and SDPA times and the bound at the prompt and the
           decode row; then MiniCPM3-4B with mla_absorb=True as phase mla
           runs it (4,030 flash launches), a decode step's ms beside the
           naive form's from phase mla, and the two forms' logits on one
           256-token prompt within bf16's 5e-2
  moe      OLMoE-1B-7B at full width and depth through
           ServeEngine(slots=8, max_seq=4096), phase lm's 16 requests (16
           prefills × 16 layers: 256 flash launches); tokens/s, time to
           first token, stats(); decode against forward in f32 on a 7-token
           prompt (no expert can overflow), and in bf16 on 1,000 tokens
           reported (not gated) beside the routings that differ and the
           capacity drops; the kernel's decode and forward against the
           plain attention's on the same routings (f32 and bf16, gated);
           the kernel on the real q, k and v of layers 0 and 15 of a
           2,048-token prefill; then granite-moe-1b-a400m at full width and
           depth (GQA 16/8, D 64): the same checks (layers 0 and 23)
  lm_train LM training: h2o-danube-1.8b at full width and depth (24
           layers, 1.83 B params, random from a seed) through the port's
           launcher loop (launch/train.py), 4 × 2,048 Markov tokens a step,
           remat "dots", 2 warm-up and 10 timed steps, with the counts set
           to 0 just before and read just after (2 flash launches a layer a
           step: 576); ms a step, tokens/s, peak memory, the losses (finite,
           falling) and grad norms; one more step under the profiler
           (device-busy share, top kernels, the attention backward's and the
           optimizer update's shares). Then one step of danube at full
           width, 2 layers, through the kernel against the plain attention
           forward (gradients within 5e-2 of their norm in bf16, 2e-3 in
           f32), and remat "dots" and "full" against "none" through the
           kernel (within 1e-6); every arch's reduced config, 2 steps on the card against
           the same on the CPU (and accum_steps=2, compress_pod_grads once
           each), the reduced MiniCPM3's (24, 16) heads through the kernel
           zero-padded to (32, 32); the attention backward (the JAX package's plain
           recompute) at danube's training shape against autograd through
           attention_ref, timed beside the kernel's forward and SDPA's
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
  compat   the drop-in surface: repro_torch.cairl.make("CartPole-v1") on the
           card, one episode on each step API with action_space.sample(),
           render() bit for bit against rasterize_ref; rollout_random at
           B = 65,536 for 256 steps and with render=True at B = 4,096 for
           64 steps, from a key made on the CPU and no device named (so on
           the card), with launch counts; HostPool("CartPole-v1", 8)
           .run_random(1000) equal to 8 PythonRunner runs; ImpactTracker
           around a make_vec rollout
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
  fused    the fused trainer (train/fused.py: steps captured into CUDA
           graphs and replayed): Table I at fig2's budget, 2,000 steps with
           chunk 0, 7 and 64, each bit for bit against phase train's
           host-alternating run (params, replay, key, metrics), 2,000
           megastep launches counted per replay; the replays alone with
           host syncs made errors, ms a step by CUDA events, and one replay
           under torch.profiler confirming the megastep count; a capture
           that syncs raises; the Pong-v0 CNN for 300 fused steps bit for
           bit against phase train's eager run, with its ring's peak and
           one replay under torch.profiler (1 megastep, 2 raster kernels);
           fleets of 1, 2, 4 and 8 rows for 500 steps, row 2 of 4 bit for
           bit against its solo run
  ppo      PPO: the training golden (tests/golden/train_ppo_CartPole-v1.json)
           on "vmap", "cuda" and fused on "cuda"; PPOConfig() at full width
           (16 envs, rollout 128, 4 × 4 minibatches, 64-64 tanh) on
           CartPole-v1, 4 updates host-alternating against 4 fused; 16 fused
           updates replayed with host syncs made errors: updates/s, env
           steps/s, megastep launches (128 an update), capture seconds and
           graph nodes
  async    the async pool and the env service on the card: the 28 committed
           goldens through send/recv (tests/test_golden.py::async_trace),
           one megastep launch per recv on the fused ids, two raster
           launches per recv on the pixel ids; EnvService at
           benchmarks/fig_async.py's traffic (CartPole-v1, 256 slots, 2,000
           sessions, session_budgets(2000, seed=0)): useful steps/s, recv
           p50/p99, occupancy, one launch per tick; AsyncEnvPool("Pong-v0",
           4096) with alternate halves ready for 256 recvs: ms and bytes
           copied to the host per recv, and one recv's masked step, from
           the staged actions to the output copy, with host syncs made
           errors; then, for every fused id, the masked "cuda" step against
           the masked "torch" step (its plain twin) at 65,536 slots (the
           pixel ids at 4,096), about half the lanes active: done,
           truncated and keys exact, the grid bodies bit for bit, the
           inactive lanes' rows unchanged bit for bit
  runtime  the fault-tolerant runtime on the card: benchmarks/fig_fault.py's
           cell (CartPole-v1, B 1,024, 2,000 supervised steps, snapshots
           off and every 16: steps/s, a snapshot's seconds); kill-and-resume
           at B = 65,536 for Maze-v0 and CartPole-v1 (snapshots every 64, a
           device loss at step 96, recover()), the resumed steps and final
           state bit for bit the uninterrupted run's, with a snapshot's
           seconds and its gather's; a 2-shard ShardedEnvPool over
           (cuda:0, cuda:0) recovered onto 1 shard, bit for bit a 1-shard
           run from the same snapshot; EnvService drained to a checkpoint
           and restored, equal to an uninterrupted oracle; a checkpoint
           written from the card restored into a device="cpu" pool, both
           continuing bit for bit on the grid body
  audit    the port's analysis gates (repro_torch.analysis): the cost
           model's rows (a JSON line each: every registry id on "vmap" and
           "cuda", and the three train steps), then the audit of every id ×
           (vmap, cuda, async, sharded) and the three fused train units:
           no host sync, no host copy past its budget (the async recv's one
           `_fetch`), the carry written in place, the async recv's launches
           equal for ready sets of 1, 2 and 8, the train graphs free of
           host nodes; raises on any violation
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
           2,048-token prefill, the same for OLMoE-1B-7B, and over
           MiniCPM3-4B's decode steps (B 4 after 2,048 tokens): wall and
           device-busy ms, idle share, the costliest kernels (last, since
           a profiler slows the launches that follow it)
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
# The work counts behind each kernel's bound are the package's: each
# wrapper's `cost` (kernels/envstep/megastep.py, kernels/raster/raster.py,
# kernels/attention/flash.py), which analysis/cost.py reads too.
#: the reset-heavy kernel case: a TimeLimit of 3 over K = 32 steps
HEAVY_MAX_STEPS = 3

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


def raster_work(segs, intens, h: int, w: int):
    """What one raster launch must move and do on these scenes
    (kernels/raster/raster.py::cost): the pixel-segment pairs of non-zero
    coverage counted on the scenes' device with the plain version's
    arithmetic, and the live (nonzero-intensity) segments."""
    from repro_torch.kernels.raster.raster import cost
    from repro_torch.kernels.raster.ref import segment_coverage

    n, s = intens.shape
    live = int((intens != 0).sum())
    covered = sum(int((c > 0).sum()) for c in segment_coverage(segs, intens,
                                                                h, w))
    return {**cost(n, s, h, w, covered, live), "covered_pairs": covered,
            "live_segments": live}


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
    """{kernel: its wrapper}; each wrapper counts its launches (a CUDA
    graph's replays add theirs: train/fused.py)."""
    from repro_torch.kernels import launch_counters

    return launch_counters()


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


_FLASH = re.compile(r"flash_(bf16_)?kernelILi(\d+)ELi(\d+)E")


def _entry_name(mangled: str) -> str:
    m = _BODY.search(mangled)
    if m:
        return m[1] + (" +TimeLimit" if m[2] == "1" else "")
    m = _FLASH.search(mangled)
    if m:
        return f"flash {'bfloat16' if m[1] else 'float32'} D={m[2]} Dv={m[3]}"
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
    Returns (state, apply_fn, metrics of (steps,), seconds, device ms per
    step, launches): `train_compiled`'s host-alternating run."""
    from repro_torch import random as R
    from repro_torch.rl import dqn

    state, apply_fn = dqn.dqn_init(env, cfg, R.PRNGKey(seed, device),
                                   device=device)
    step_fn = dqn.make_train_step(env, apply_fn, cfg, device)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    history = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    events[0].record()
    try:
        for i in range(steps):
            if i == 1:
                torch.cuda.set_sync_debug_mode("error")
            state, metrics = step_fn(state)
            history.append(metrics)
            events[i + 1].record()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    metrics = {k: torch.stack([m[k] for m in history]) for k in history[0]}
    return state, apply_fn, metrics, seconds, step_ms, counts


def phase_train(torch, device):
    """DQN through the port's learner on the card: the megastep at the
    learner's widths, the two training goldens, Table I on CartPole-v1,
    train_host on the interpreted CartPole, the pixel CNN on Pong-v0 at
    Table I's memory, the CNN on the card against the CPU under PyTorch's
    TF32 default, greedy returns. Returns (launches, the megastep's error,
    the eager runs that phase fused is held against: {"table_i": (env,
    cfg, state, apply_fn, metrics), "pong": `dqn_snapshot` of the Pong-v0
    run})."""
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
    state, apply_fn, metrics, sec, step_ms, counts = run_training(
        torch, env, cfg, TABLE_I_STEPS, 0, device)
    loss = metrics["loss"]
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
    table_i = (env, cfg, state, apply_fn, metrics)

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
    pstate, papply, pmetrics, psec, pms, pcounts = run_training(
        torch, pong, pcfg, PONG_STEPS, 0, device)
    ploss = pmetrics["loss"]
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
    pong_run = dqn_snapshot(torch, pstate, pmetrics)
    del pstate, ring, x
    torch.cuda.empty_cache()
    emit(out)
    return launches, mega_err, {"table_i": table_i, "pong": pong_run}


def dqn_snapshot(torch, state, metrics):
    """A copy of a DQN state and its metrics small enough to keep beside
    another run: every leaf, but of the replay ring only the rows written
    so far (`size`; a ring that has not wrapped), after checking that every
    later row is still 0 as `replay_init` made it. Two snapshots are equal
    only if the two states and metrics are."""
    from torch.utils._pytree import tree_map

    r = state.replay
    n = int(r.size)
    if int(r.ptr) != n:
        raise AssertionError(f"dqn_snapshot: the ring has wrapped ({n})")
    rows = {f: getattr(r, f) for f in ("obs", "action", "reward",
                                       "next_obs", "done")}
    for f, x in rows.items():
        if bool((x[n:] != 0).any()):
            raise AssertionError(f"dqn_snapshot: replay.{f} holds rows past "
                                 f"its size {n}")
    replay = r._replace(**{f: x[:n] for f, x in rows.items()})
    return tree_map(lambda x: x.clone(), (state._replace(replay=replay),
                                          metrics))


def phase_train_profile(torch, eager):
    """torch.profiler over TRAIN_PROFILE_STEPS Table I steps carried on
    from phase train: wall and device-busy ms a step, idle share, launches
    a step, and each layer of the step read from its `dqn.STAGES` range
    (near the end: a profiler slows what follows it). Also what a range
    costs the step when no profiler runs."""
    from torch.profiler import record_function

    from repro_torch.rl import dqn

    env, cfg, state, apply_fn, _ = eager["table_i"]
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


# -- the drop-in surface, PPO and the fused trainer ----------------------------

#: phase compat: the runners' widths and depths
COMPAT_B, COMPAT_STEPS = 65536, 256
COMPAT_RENDER_B, COMPAT_RENDER_STEPS = 4096, 64
HOST_POOL_ENVS, HOST_POOL_STEPS = 8, 1000
IMPACT_B, IMPACT_STEPS = 65536, 256
#: phase ppo: PPOConfig()'s rollout at full width
PPO_PARITY_UPDATES, PPO_TIMED_UPDATES = 4, 16
#: phase fused: Table I at fig2's `_cfg()` and budget (and the Pong-v0 CNN
#: at phase train's); the chunks held against it; the fleets
FUSED_CHUNKS = (7, 64)
FLEET_WIDTHS, FLEET_STEPS = (1, 2, 4, 8), 500
FLEET_SEEDS = (11, 12, 13, 14, 15, 16, 17, 18)


def _tree_equal(torch, a, b) -> bool:
    from torch.utils._pytree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _tree_max_err(torch, a, b) -> float:
    """Largest |a - b| over the float leaves; ints and keys must be equal."""
    from torch.utils._pytree import tree_leaves

    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if x.dtype.is_floating_point:
            worst = max(worst, float((x.double() - y.double()).abs().max())
                        if x.numel() else 0.0)
        elif not torch.equal(x, y):
            raise AssertionError(f"an integer leaf differs: {x.dtype}"
                                 f"{tuple(x.shape)}")
    return worst


def _cudart():
    """The CUDA runtime PyTorch loaded, for `cudaGraphGetNodes`, or None."""
    import ctypes

    for line in Path("/proc/self/maps").read_text().splitlines():
        path = line.split()[-1]
        if "libcudart.so" in path:
            lib = ctypes.CDLL(path)
            lib.cudaGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                              ctypes.POINTER(ctypes.c_size_t)]
            return lib
    return None


@contextlib.contextmanager
def kept_graphs(torch):
    """Every `torch.cuda.CUDAGraph` made inside the block keeps its graph
    (`keep_graph=True`, instantiated at the end of its capture as by
    default), so `graph_nodes` can count its nodes. Yields a list of weak
    references to the graphs made (a strong one would tie each graph into
    a cycle through this class, for the collector to free at any time)."""
    import weakref

    made, original = [], torch.cuda.CUDAGraph

    class Kept(original):
        def __new__(cls, *args, **kwargs):
            graph = super().__new__(cls, keep_graph=True)
            made.append(weakref.ref(graph))
            return graph

        def __init__(self, *args, **kwargs):
            super().__init__(keep_graph=True)

        def capture_end(self):
            super().capture_end()
            try:
                self.instantiate()
            except RuntimeError:    # instantiated already
                pass

    torch.cuda.CUDAGraph = Kept
    try:
        yield made
    finally:
        torch.cuda.CUDAGraph = original


def graph_nodes(ref):
    """Nodes of a kept CUDA graph (a weak reference from `kept_graphs`:
    kernels, copies, fills), or None where the graph or the runtime cannot
    be reached."""
    import ctypes

    try:
        raw = ref().raw_cuda_graph()
        lib = _cudart()
    except (RuntimeError, OSError, AttributeError):
        return None
    if lib is None:
        return None
    count = ctypes.c_size_t(0)
    rc = lib.cudaGraphGetNodes(ctypes.c_void_p(raw), None, ctypes.byref(count))
    return int(count.value) if rc == 0 else None


def phase_compat(torch, device, smi):
    """The paper's drop-in surface on the card: `cairl.make` (both step
    APIs, sampled actions, render() against rasterize_ref bit for bit), the
    runners, the host pool against PythonRunner, and ImpactTracker around a
    pool rollout. Returns the launch counts of these paths."""
    import numpy as np

    import repro_torch
    from repro_torch import cairl
    from repro_torch import random as R
    from repro_torch.core import runner
    from repro_torch.envs.baseline_python import CartPolePy
    from repro_torch.kernels.raster import rasterize_ref
    from repro_torch.pool import HostPool
    from repro_torch.sustainability.impact import ImpactTracker

    t0 = time.perf_counter()
    out = {"phase": "compat"}
    launches = {"megastep": 0, "raster": 0}

    def tally():
        counts = read_counts()
        for k in launches:
            launches[k] += counts[k]
        return counts

    reset_counts()
    episodes = {}
    for api in (False, True):
        e = cairl.make("CartPole-v1", seed=int(api), new_step_api=api)
        if e.device.type != "cuda":
            raise AssertionError(f"cairl.make ran on {e.device}")
        obs, ret, steps, done = e.reset(), 0.0, 0, False
        while not done:
            step = e.step(e.action_space.sample())
            obs, ret, steps = step[0], ret + step[1], steps + 1
            done = any(step[2:-1])
            if not np.isfinite(obs).all() or steps > 500:
                raise AssertionError(f"cairl.make episode: obs {obs}, "
                                     f"{steps} steps")
        frame = e.render()
        segs, intens = e.unwrapped.scene(e._state.inner)
        ref = rasterize_ref(segs[None], intens[None], 84, 84)[0].cpu().numpy()
        if not np.array_equal(frame, ref):
            raise AssertionError("render() differs from rasterize_ref by "
                                 f"{np.abs(frame - ref).max()}")
        episodes["5-tuple" if api else "4-tuple"] = {
            "steps": steps, "return": ret, "frame_max": float(frame.max())}
    out["cairl_make"] = {"episodes": episodes, "render_vs_ref": "bit for bit",
                         "launches": tally()}

    env = repro_torch.make("CartPole-v1")
    rollouts = {}
    for b, steps, render in ((COMPAT_B, COMPAT_STEPS, False),
                             (COMPAT_RENDER_B, COMPAT_RENDER_STEPS, True)):
        torch.cuda.synchronize()
        reset_counts()
        t1 = time.perf_counter()
        # the JAX-style call: a key made on the CPU, no device named
        rew, eps, frame = runner.rollout_random(env, R.PRNGKey(5), steps, b,
                                                render=render)
        torch.cuda.synchronize()
        if rew.device.type != "cuda" or frame.device.type != "cuda":
            raise AssertionError(f"rollout_random ran on {rew.device}")
        sec, counts = time.perf_counter() - t1, tally()
        want = {"megastep": 0, "raster": steps + 1 if render else 0,
                "flash": 0}
        if counts != want or int(eps.sum()) < 1 or not bool(
                torch.isfinite(rew).all()):
            raise AssertionError(f"rollout_random B={b}: launches {counts} "
                                 f"(want {want}), {int(eps.sum())} episodes")
        rollouts[f"B={b},render={render}"] = {
            "steps": steps, "seconds": sec, "env_steps_per_s": b * steps / sec,
            "episodes": int(eps.sum()), "launches": counts,
            "frame_shape": list(frame.shape)}
    out["rollout_random"] = rollouts

    t1 = time.perf_counter()
    pool = HostPool("CartPole-v1", HOST_POOL_ENVS)
    try:
        totals, eps = pool.run_random(HOST_POOL_STEPS, seed=3)
    finally:
        pool.close()
    host_sec = time.perf_counter() - t1
    solo = [runner.PythonRunner(CartPolePy).run(HOST_POOL_STEPS, seed=3 + i)
            for i in range(HOST_POOL_ENVS)]
    if [(float(t), int(n)) for t, n in zip(totals, eps)] != [
            (float(np.float32(t)), n) for t, n in solo]:
        raise AssertionError("HostPool.run_random differs from PythonRunner")
    out["host_pool"] = {"envs": HOST_POOL_ENVS, "steps": HOST_POOL_STEPS,
                        "seconds": host_sec, "episodes": [int(n) for n in eps],
                        "equal_to_python_runner": True}

    pool = repro_torch.make_vec("CartPole-v1", IMPACT_B, unroll=K)
    reset_counts()
    with ImpactTracker() as tracker:
        pool.rollout(IMPACT_STEPS, R.PRNGKey(7, device))
        torch.cuda.synchronize()
    counts = tally()
    if counts["megastep"] != IMPACT_STEPS // K:
        raise AssertionError(f"impact rollout: launches {counts}")
    out["impact"] = {"rollout": f"make_vec('CartPole-v1', {IMPACT_B}, "
                                f"unroll={K}).rollout({IMPACT_STEPS})",
                     "report": tracker.impact.report(), "launches": counts,
                     "envelope": "the paper's CPU (95 W TDP); the card's "
                                 "power is not modelled",
                     "card": smi}
    out.update(launches=launches, seconds=time.perf_counter() - t0)
    emit(out)
    return launches


def _ppo_golden(torch, device, backend, fused):
    """One run of the PPO training golden on the card against the committed
    JSON: (max error of the floats, megastep launches)."""
    import dataclasses

    import numpy as np

    import repro_torch
    from repro_torch import random as R
    from repro_torch.rl import dqn, ppo
    from repro_torch.train import golden_train_setup

    gid = "ppo/CartPole-v1"
    want = json.loads((ROOT / "tests" / "golden" / "train_ppo_CartPole-v1.json")
                      .read_text())
    _, env_id, cfg, updates = golden_train_setup(gid)
    cfg = dataclasses.replace(cfg, env_backend=backend)
    env = repro_torch.make(env_id)
    reset_counts()
    state, _ = ppo.train(env, cfg, updates, R.PRNGKey(sum(map(ord, gid)),
                                                      device), fused=fused)
    counts = read_counts()
    got = dqn.golden_checksums(
        env, state, lambda p, o: ppo.ac_apply(p, o, cfg.activation)[0])
    if got["final_key"] != want["final_key"]:
        raise AssertionError(f"{gid} on {backend}: final_key "
                             f"{got['final_key']} != {want['final_key']}")
    floats = [k for k, v in want.items() if isinstance(v, float)]
    for k in floats:
        np.testing.assert_allclose(got[k], want[k], rtol=GOLDEN_TOL,
                                   atol=GOLDEN_TOL, err_msg=f"{gid}.{k}")
    want_launches = updates * cfg.rollout_len if backend == "cuda" else 0
    if counts["megastep"] != want_launches:
        raise AssertionError(f"{gid} on {backend}: {counts} launches")
    return max(abs(got[k] - want[k]) for k in floats), counts["megastep"]


def phase_ppo(torch, device):
    """PPO on the card: the training golden on "vmap" and "cuda" (and
    fused on "cuda"); PPOConfig() at full width on CartPole-v1, 4 updates
    host-alternating against 4 fused (the parity contract, and whether they
    agree bit for bit); then 16 fused updates from captured graphs, timed.
    Returns the megastep launches of these paths."""
    from repro_torch import make
    from repro_torch import random as R
    from repro_torch.rl import ppo
    from repro_torch.train import fused as F

    t0 = time.perf_counter()
    out, launches = {"phase": "ppo"}, 0
    goldens = {}
    for backend, fused in (("vmap", False), ("cuda", False), ("cuda", True)):
        err, n = _ppo_golden(torch, device, backend, fused)
        goldens[f"{backend}{',fused' if fused else ''}"] = {
            "max_abs_err": err, "megastep_launches": n}
        launches += n
    out["golden"] = goldens

    env, cfg = make("CartPole-v1"), ppo.PPOConfig(env_backend="cuda")
    reset_counts()
    t1 = time.perf_counter()
    host, host_m = ppo.train(env, cfg, PPO_PARITY_UPDATES, R.PRNGKey(0, device))
    torch.cuda.synchronize()
    host_sec = time.perf_counter() - t1
    fused, fused_m = ppo.train(env, cfg, PPO_PARITY_UPDATES,
                               R.PRNGKey(0, device), fused=True)
    torch.cuda.synchronize()
    counts = read_counts()
    want = 2 * PPO_PARITY_UPDATES * cfg.rollout_len
    if counts["megastep"] != want:
        raise AssertionError(f"PPO parity: {counts}, want {want} megastep")
    launches += want
    err = max(_tree_max_err(torch, host, fused),
              _tree_max_err(torch, host_m, fused_m))
    if err > 1e-4:
        raise AssertionError(f"PPO fused against host-alternating: {err}")
    out["parity"] = {
        "updates": PPO_PARITY_UPDATES, "bit_for_bit": _tree_equal(
            torch, (host, host_m), (fused, fused_m)),
        "max_abs_err": err, "host_seconds": host_sec,
        "host_ms_per_update": 1e3 * host_sec / PPO_PARITY_UPDATES,
        "return": [float(x) for x in host_m["return"]]}

    # 16 updates replayed from captured graph units, after the capture
    state = ppo.ppo_init(env, cfg, R.PRNGKey(1, device))
    run = F.fused_train_chunk(ppo.make_update_body(env, cfg, device))
    reset_counts()
    with kept_graphs(torch) as graphs:
        t1 = time.perf_counter()
        carry, _ = run(state, F.WARMUP_STEPS + F.UNIT_STEPS)
        torch.cuda.synchronize()
        first_sec = time.perf_counter() - t1
    nodes = [graph_nodes(g) for g in graphs]
    launches += read_counts()["megastep"]
    reset_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t1 = time.perf_counter()
    start.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry, metrics = run(carry, PPO_TIMED_UPDATES)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    end.record()
    end.synchronize()
    sec = time.perf_counter() - t1
    counts = read_counts()
    want = PPO_TIMED_UPDATES * cfg.rollout_len
    if counts["megastep"] != want or run.stats["replays"] != (
            F.UNIT_STEPS + PPO_TIMED_UPDATES) // F.UNIT_STEPS:
        raise AssertionError(f"PPO timed: {counts} (want {want} megastep), "
                             f"stats {run.stats}")
    if not bool(torch.isfinite(metrics["loss"]).all()):
        raise AssertionError("PPO timed: a loss is not finite")
    launches += want
    env_steps = PPO_TIMED_UPDATES * cfg.rollout_len * cfg.num_envs
    out["timed"] = {
        "updates": PPO_TIMED_UPDATES, "unit_steps": F.UNIT_STEPS,
        "seconds": sec, "device_ms": start.elapsed_time(end),
        "updates_per_s": PPO_TIMED_UPDATES / sec,
        "env_steps_per_s": env_steps / sec, "megastep_launches": counts[
            "megastep"],
        "capture_seconds": run.stats["capture"]["seconds"],
        "first_call_seconds": first_sec, "graph_nodes": nodes,
        "sync_free": True, "return_last": float(metrics["return"][-1]),
        "clock": "host clock around the replays and a synchronize; "
                 "device_ms by CUDA events"}
    out.update(launches=launches, seconds=time.perf_counter() - t0)
    emit(out)
    return launches


def _profile_replay(torch, run, carry, n):
    """Kernels in a torch.profiler trace of `run(carry, n)` (one replay of
    a cached graph): (carry, megastep kernels, raster kernels, all
    kernels, device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        carry, _ = run(carry, n)
        torch.cuda.synchronize()
    kernels = [e for e in p.key_averages() if e.device_type == DeviceType.CUDA]
    mega = sum(e.count for e in kernels if "megastep_kernel" in e.key)
    raster = sum(e.count for e in kernels if "raster_kernel" in e.key)
    return carry, mega, raster, sum(e.count for e in kernels), sum(
        e.self_device_time_total for e in kernels) / 1e3


def phase_fused(torch, device, eager):
    """The fused trainer on the card, held against phase train's
    host-alternating runs: Table I (2,000 steps from PRNGKey(0)), final
    params, replay, key and metrics bit for bit with chunk 0, 7 and 64; no
    host sync in the replays; launches counted per replay and confirmed by
    the profiler; ms a step by CUDA events; the Pong-v0 CNN's 300 fused
    steps bit for bit against the eager run, with its ring's peak and one
    replay profiled; fleets of 1, 2, 4 and 8 rows, row 2 of 4 against its
    solo run. Returns the launches of these paths."""
    from torch.utils._pytree import tree_map

    from repro_torch import make
    from repro_torch import random as R
    from repro_torch.rl import dqn
    from repro_torch.train import fleet
    from repro_torch.train import fused as F

    env, cfg, host, _, host_m = eager["table_i"]
    t0 = time.perf_counter()
    out = {"phase": "fused", "unit_steps": F.UNIT_STEPS,
           "warmup_steps": F.WARMUP_STEPS}
    mega = 0
    runs = {}
    for chunk in (0,) + FUSED_CHUNKS:
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, _, metrics = dqn.train_compiled(
            env, cfg, TABLE_I_STEPS, R.PRNGKey(0, device), chunk=chunk,
            fused=True)
        torch.cuda.synchronize()
        sec, counts = time.perf_counter() - t1, read_counts()
        if counts["megastep"] != TABLE_I_STEPS:
            raise AssertionError(f"fused chunk={chunk}: launches {counts}")
        equal = _tree_equal(torch, (host, host_m), (state, metrics))
        if not equal:
            raise AssertionError(f"fused chunk={chunk} differs from the "
                                 "host-alternating run: max error "
                                 f"{_tree_max_err(torch, host, state)}")
        mega += counts["megastep"]
        runs[str(chunk)] = {"seconds": sec, "bit_for_bit": equal,
                            "launches": counts}
        del state, metrics
    out["table_i"] = runs

    # the replays alone: no host sync, device ms a step, the profiler's count
    state, apply_fn = dqn.dqn_init(env, cfg, R.PRNGKey(0, device))
    run = F.fused_train_chunk(dqn.make_train_step(env, apply_fn, cfg, device))
    reset_counts()
    with kept_graphs(torch) as graphs:
        carry, _ = run(state, F.WARMUP_STEPS + F.UNIT_STEPS)
    nodes = graph_nodes(graphs[0])
    mega += read_counts()["megastep"]
    n = (TABLE_I_STEPS // F.UNIT_STEPS) * F.UNIT_STEPS
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    start.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry, metrics = run(carry, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    end.record()
    end.synchronize()
    sec, counts = time.perf_counter() - t1, read_counts()
    if counts["megastep"] != n:
        raise AssertionError(f"replays: {counts}, want {n} megastep")
    mega += n
    with uncounted():
        carry, prof_mega, _, prof_kernels, prof_ms = _profile_replay(
            torch, run, carry, F.UNIT_STEPS)
    if prof_mega != F.UNIT_STEPS:
        raise AssertionError(f"the profiler saw {prof_mega} megastep kernels "
                             f"in one replay of {F.UNIT_STEPS} steps")
    out["replays"] = {
        "steps": n, "seconds": sec, "ms_per_step": start.elapsed_time(end) / n,
        "transitions_per_s": n / sec, "sync_free": True,
        "megastep_launches": counts["megastep"],
        "graph_nodes_per_unit": nodes, "warmup_steps": run.stats[
            "warmup_steps"],
        "capture": run.stats["capture"],
        "profiler_one_replay": {"megastep_kernels": prof_mega,
                                "kernels": prof_kernels,
                                "device_busy_ms": prof_ms},
        "clock": "ms_per_step by CUDA events around the replays; seconds "
                 "by the host clock and a synchronize"}
    del carry, state

    # a capture that syncs raises, and the card works on after it
    def syncs(carry):
        float(carry.step)
        return carry, {"step": carry.step.float()}

    state, _ = dqn.dqn_init(env, cfg, R.PRNGKey(1, device))
    try:
        F.fused_train_chunk(syncs)(state, F.WARMUP_STEPS + 2)
    except RuntimeError as e:
        refused = str(e).splitlines()[0][:160]
    else:
        raise AssertionError("a capture that syncs did not raise")
    if float(torch.ones(4, device=device).sum()) != 4.0:
        raise AssertionError("the card failed after a refused capture")
    out["refused_capture"] = refused

    # the Pong-v0 CNN: the 11.29 GB ring exists once
    pong = make("Pong-v0")
    pcfg = dqn.DQNConfig(**PONG_CFG, env_backend="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    t1 = time.perf_counter()
    pstate, papply, pmetrics = dqn.train_compiled(
        pong, pcfg, PONG_STEPS, R.PRNGKey(0, device), fused=True)
    torch.cuda.synchronize()
    psec, pcounts = time.perf_counter() - t1, read_counts()
    peak = torch.cuda.max_memory_allocated() - base
    ring = sum(x.numel() * x.element_size()
               for x in (pstate.replay.obs, pstate.replay.next_obs))
    want = {"megastep": PONG_STEPS, "raster": 2 * PONG_STEPS + 1}
    if {k: pcounts[k] for k in want} != want or peak > 1.05 * ring:
        raise AssertionError(f"Pong-v0 fused: launches {pcounts} (want "
                             f"{want}), peak {peak} for a {ring}-byte ring")
    if not bool(torch.isfinite(pmetrics["loss"]).all()):
        raise AssertionError("Pong-v0 fused: a loss is not finite")
    if not _tree_equal(
            torch, eager["pong"], dqn_snapshot(torch, pstate, pmetrics)):
        raise AssertionError("Pong-v0 fused differs from phase train's "
                             "eager run")
    mega, raster = mega + pcounts["megastep"], pcounts["raster"]
    # one Pong-v0 replay under the profiler: 1 megastep, 2 raster kernels
    run = F.fused_train_chunk(dqn.make_train_step(pong, papply, pcfg, device))
    reset_counts()
    carry, _ = run(pstate, F.WARMUP_STEPS + F.UNIT_STEPS)
    counts = read_counts()
    mega, raster = mega + counts["megastep"], raster + counts["raster"]
    with uncounted():
        carry, prof_mega, prof_raster, prof_kernels, prof_ms = \
            _profile_replay(torch, run, carry, F.UNIT_STEPS)
    if (prof_mega, prof_raster) != (F.UNIT_STEPS, 2 * F.UNIT_STEPS):
        raise AssertionError(f"the profiler saw {prof_mega} megastep and "
                             f"{prof_raster} raster kernels in one Pong-v0 "
                             f"replay of {F.UNIT_STEPS} steps")
    out["pong_cnn"] = {"steps": PONG_STEPS, "seconds": psec,
                       "ms_per_step": 1e3 * psec / PONG_STEPS,
                       "launches": pcounts, "ring_bytes": ring,
                       "peak_bytes_above_start": peak,
                       "bit_for_bit_with_eager": True,
                       "profiler_one_replay": {
                           "megastep_kernels": prof_mega,
                           "raster_kernels": prof_raster,
                           "kernels": prof_kernels,
                           "device_busy_ms": prof_ms},
                       "clock": "host clock, captures included"}
    del pstate, pmetrics, carry, run
    torch.cuda.empty_cache()

    # fleets: F rows of Table I, one graph unit for all rows
    fleets = {}
    for width in FLEET_WIDTHS:
        seeds = list(FLEET_SEEDS[:width])
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        states, metrics = fleet(env, seeds, FLEET_STEPS, cfg=cfg)
        torch.cuda.synchronize()
        sec, counts = time.perf_counter() - t1, read_counts()
        if counts["megastep"] != width * FLEET_STEPS:
            raise AssertionError(f"fleet {width}: launches {counts}")
        mega += counts["megastep"]
        fleets[str(width)] = {"seconds": sec, "runs_per_s": width / sec,
                              "steps": FLEET_STEPS,
                              "transitions_per_s": width * FLEET_STEPS / sec,
                              "launches": counts}
        if width == 4:
            reset_counts()
            solo, _, solo_m = dqn.train_compiled(
                env, cfg, FLEET_STEPS, R.PRNGKey(seeds[2], device), fused=True)
            solo_mega = read_counts()["megastep"]
            if solo_mega != FLEET_STEPS:
                raise AssertionError(f"fleet row 2's solo run: {solo_mega} "
                                     "megastep launches")
            mega += solo_mega
            row = {k: v[2] for k, v in metrics.items()}
            if not _tree_equal(torch, (solo, solo_m),
                               (tree_map(lambda x: x[2], states), row)):
                raise AssertionError("fleet row 2 of 4 differs from its solo "
                                     "run")
            fleets["4"]["row_2_equals_solo"] = True
        del states, metrics
    out["fleets"] = fleets
    launches = {"megastep": mega, "raster": raster}
    out.update(launches=launches, seconds=time.perf_counter() - t0)
    emit(out)
    return launches


def phase_unit_sweep(torch, device, units=(1, 2, 4, 8, 16, 32), steps=512,
                     ppo_units=(1, 2, 4, 8), ppo_updates=16, rounds=3):
    """What a graph unit of `u` steps costs, for choosing
    `train/fused.py::UNIT_STEPS`. For Table I DQN (units `units`, windows
    of `steps` steps) and PPOConfig() on "cuda" (units `ppo_units`,
    windows of `ppo_updates` updates): each unit's runner captures once
    (capture seconds, graph nodes), then every runner replays one window
    per round, the units interleaved, `rounds` rounds: device ms a step
    by CUDA events and host ms a step until the window is queued, each
    round's value and their spread. Not run by main(); run it alone."""
    import dataclasses

    from repro_torch import make
    from repro_torch import random as R
    from repro_torch.configs.cairl_dqn import PAPER_TABLE_I
    from repro_torch.rl import dqn, ppo
    from repro_torch.train import fused as F

    env = make("CartPole-v1")
    cfg = dataclasses.replace(PAPER_TABLE_I, num_envs=1, learn_start=100,
                              env_backend="cuda")
    pcfg = ppo.PPOConfig(env_backend="cuda")
    t0 = time.perf_counter()
    rows = []
    with uncounted():
        for algo, us, n in (("dqn", units, steps), ("ppo", ppo_units,
                                                     ppo_updates)):
            for u in us:
                if algo == "dqn":
                    init, apply_fn = dqn.dqn_init(env, cfg,
                                                  R.PRNGKey(0, device))
                    step_fn = dqn.make_train_step(env, apply_fn, cfg, device)
                else:
                    init = ppo.ppo_init(env, pcfg, R.PRNGKey(0, device))
                    step_fn = ppo.make_update_body(env, pcfg, device)
                run = F._GraphRunner(step_fn, u)
                with kept_graphs(torch) as graphs:
                    carry, _ = run(init, F.WARMUP_STEPS + u)
                    torch.cuda.synchronize()
                rows.append({"algo": algo, "unit_steps": u,
                             "window_steps": n // u * u,
                             "capture_seconds": run.stats["capture"][
                                 "seconds"],
                             "graph_nodes": graph_nodes(graphs[0]),
                             "device_ms_per_step": [],
                             "host_ms_per_step": [], "_run": run,
                             "_carry": carry})
        for _ in range(rounds):
            for row in rows:
                n = row["window_steps"]
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                start.record()
                row["_carry"], _ = row["_run"](row["_carry"], n)
                end.record()
                host = time.perf_counter() - t1
                end.synchronize()
                row["device_ms_per_step"].append(start.elapsed_time(end) / n)
                row["host_ms_per_step"].append(1e3 * host / n)
    for row in rows:
        del row["_run"], row["_carry"]
        ms = row["device_ms_per_step"]
        row.update(device_ms_median=statistics.median(ms),
                   device_ms_spread=(max(ms) - min(ms)) / statistics.median(
                       ms))
        emit({"phase": "unit_sweep", **row})
    emit({"phase": "unit_sweep", "rounds": rounds,
          "seconds": time.perf_counter() - t0,
          "clock": "device ms by CUDA events around a window of replays; "
                   "host ms until the window was queued"})
    return rows


# -- the async pool, the env service and the fault-tolerant runtime ----------

#: the masked-step check: 65,536 slots, the pixel ids at the pixel path's
#: 4,096 (a 65,536-slot frame table and its plain twin's outputs would not
#: fit beside the selects); steps per id, the first with every lane active
MASKED_B, MASKED_STEPS, MASKED_PIXEL_STEPS = 65536, 16, 8
#: benchmarks/fig_async.py's defaults: CartPole-v1, 256 slots, 2,000
#: sessions with budgets from session_budgets(2000, seed=0)
SERVICE_ID, SERVICE_SLOTS, SERVICE_SESSIONS = "CartPole-v1", 256, 2000
#: the pixel path at full width: alternate halves ready for 256 recvs
ASYNC_PIXEL_ID, ASYNC_PIXEL_SLOTS, ASYNC_PIXEL_RECVS = "Pong-v0", 4096, 256
#: benchmarks/fig_fault.py's defaults: CartPole-v1, B 1,024, 2,000 steps,
#: snapshots off and every 16
FAULT_ID, FAULT_B, FAULT_STEPS, FAULT_EVERY = "CartPole-v1", 1024, 2000, 16
SNAPSHOT_REPS = 5
#: kill-and-resume: a device loss at step 96, snapshots every 64
KILL_IDS, KILL_B, KILL_EVERY, KILL_AT, KILL_END = (
    ("Maze-v0", "CartPole-v1"), 65536, 64, 96, 128)
#: the 2-to-1-shard re-mesh, the drained service, the cross-device restore
REMESH_B, REMESH_EVERY, REMESH_KILL, REMESH_END = 65536, 8, 12, 16
DRAIN_SLOTS, DRAIN_SESSIONS, DRAIN_TICKS = 64, 300, 20
XDEV_ID, XDEV_B, XDEV_STEPS = "Maze-v0", 1024, 32


def session_budgets(num_sessions: int, seed: int = 0, short: int = 8,
                    long: int = 128):
    """benchmarks/fig_async.py's long-tailed budget mixture: mostly 1 to
    `short` steps, a tenth `short` to `long` (a copy: this script imports
    nothing of the JAX package)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    budgets = rng.integers(1, short + 1, size=num_sessions)
    tail = rng.random(num_sessions) < 0.1
    budgets[tail] = rng.integers(short, long + 1, size=int(tail.sum()))
    return [int(b) for b in budgets]


def _host_actions(space, rng, n):
    """n actions of `space` drawn on the host, as a client sends them."""
    import numpy as np

    if hasattr(space, "n"):
        return rng.integers(0, space.n, n).astype(np.int32)
    return rng.uniform(-2.0, 2.0, (n,) + tuple(space.shape)).astype(np.float32)


def _tree_equal(torch, a, b) -> bool:
    from torch.utils._pytree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _np_tree_equal(a, b) -> bool:
    import numpy as np
    from torch.utils._pytree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(np.array_equal(x, y)
                                      for x, y in zip(la, lb))


def async_goldens(torch, device):
    """The 28 committed goldens through send/recv on the card
    (tests/test_golden.py::async_trace): `reset(seed)`, then per step
    `send` and `recv(key=fold_in(key, t))`. One megastep launch per recv
    on the fused ids, two raster launches per recv and one for the reset on
    the pixel ids."""
    import numpy as np

    import repro_torch
    from repro_torch import random as R
    from repro_torch.core.spaces import sample_batch

    worst, backends, launches = {}, {}, {}
    for env_id in GOLDEN_IDS:
        want = json.loads((ROOT / "tests" / "golden" / f"{env_id}.json")
                          .read_text())
        b, steps = want["batch"], want["steps"]
        pool = repro_torch.make_vec(env_id, b, backend="async", device=device)
        backends[env_id] = pool.backend
        seed = sum(map(ord, env_id))
        key = R.PRNGKey(seed, device)
        reset_counts()
        obs0 = pool.reset(seed=seed)
        rows = []
        for t in range(steps):
            a = sample_batch(pool.action_space, R.fold_in(key, 1000 + t), b)
            pool.send(a, np.arange(b))
            obs, rew, done, _, _ = pool.recv(key=R.fold_in(key, t))
            rows.append([float(np.asarray(obs, np.float64).sum()),
                         float(np.asarray(rew, np.float64).sum()),
                         int(np.asarray(done).sum())])
        got = read_counts()
        pixel = len(pool.observation_space.shape) >= 2
        expect = {"megastep": steps if pool.backend == "cuda" else 0,
                  "raster": 2 * steps + 1 if pixel else 0, "flash": 0}
        if got != expect:
            raise AssertionError(f"{env_id}: async launches {got}, want "
                                 f"{expect}")
        launches[env_id] = got
        np.testing.assert_allclose(float(obs0.double().sum()),
                                   want["reset_obs_sum"], rtol=GOLDEN_TOL,
                                   atol=GOLDEN_TOL, err_msg=env_id)
        np.testing.assert_allclose(rows, want["rows"], rtol=GOLDEN_TOL,
                                   atol=GOLDEN_TOL, err_msg=f"{env_id} async")
        worst[env_id] = float(np.abs(np.subtract(rows, want["rows"])).max())
    total = {n: sum(c[n] for c in launches.values()) for n in launches[
        GOLDEN_IDS[0]]}
    return {"max_abs_err": worst, "backends": backends,
            "launches": total}


def masked_check(torch, device, env_id, b, steps, seed):
    """The masked "cuda" step against the masked "torch" step (its plain
    twin) on the card, through two async pools from one reset: the first
    step with every lane active, then about half the lanes each step. Done,
    truncated and the keys exact, the grid bodies bit for bit, the rest at
    1e-5/1e-6; the inactive lanes' rows (state, key, obs) bit for bit what
    they were. Launches here are comparisons, not main-path launches."""
    import numpy as np
    from torch.utils._pytree import tree_leaves

    from repro_torch.pool import AsyncEnvPool

    rng = np.random.default_rng(seed)
    pools = {be: AsyncEnvPool(env_id, b, backend=be, device=device)
             for be in ("cuda", "torch")}
    for pool in pools.values():
        pool.reset(seed=seed)
    grid = env_id in GRID_IDS
    err, resets, idle_lanes = 0.0, 0, 0
    for t in range(steps):
        ids = (np.arange(b) if t == 0
               else np.flatnonzero(rng.random(b) < 0.5))
        acts = _host_actions(pools["cuda"].action_space, rng, len(ids))
        cuda = pools["cuda"]
        idle = torch.ones(b, dtype=torch.bool, device=device)
        idle[torch.from_numpy(ids).to(device)] = False
        before = [x[idle].clone() for x in tree_leaves(cuda._state)
                  + [cuda._obs]]
        out = {}
        for be, pool in pools.items():
            pool.send(acts, ids)
            out[be] = pool.recv()
        got, want = out["cuda"], out["torch"]
        if not np.array_equal(got[4], want[4]):
            raise AssertionError(f"{env_id}: recv ids differ")
        fields = {"obs": (got[0], want[0]), "reward": (got[1], want[1]),
                  "done": (got[2], want[2]),
                  **{k: (got[3][k], want[3][k]) for k in want[3]}}
        for what, (g, w) in fields.items():
            if g.dtype.kind != "f" or grid:
                if not np.array_equal(g, w):
                    raise AssertionError(f"{env_id} step {t}: {what} differs "
                                         "from the plain twin")
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{env_id} {what} {t}")
                err = max(err, float(np.abs(g - w).max()))
        if not torch.equal(cuda._state.key, pools["torch"]._state.key):
            raise AssertionError(f"{env_id} step {t}: keys differ")
        if grid and not _tree_equal(torch, cuda._state,
                                    pools["torch"]._state):
            raise AssertionError(f"{env_id} step {t}: states differ")
        after = [x[idle] for x in tree_leaves(cuda._state) + [cuda._obs]]
        if not all(torch.equal(x, y) for x, y in zip(before, after)):
            raise AssertionError(f"{env_id} step {t}: an inactive lane moved")
        resets += int(got[2].sum())
        idle_lanes += int(idle.sum())
    return {"id": env_id, "B": b, "steps": steps, "resets": resets,
            "idle_lane_steps": idle_lanes, "max_abs_err": err}


def service_run(torch, device):
    """fig_async.py's traffic through EnvService on the card: useful
    steps/s, recv p50/p99, occupancy, and one megastep launch per tick."""
    from repro_torch.serving import EnvService, Session

    budgets = session_budgets(SERVICE_SESSIONS, seed=0)
    svc = EnvService(SERVICE_ID, SERVICE_SLOTS, device=device)
    svc.submit(Session(sid=-1, seed=0, num_steps=1))    # warm, as fig_async
    svc.run()
    svc.ticks = svc.steps_served = 0
    svc.recv_latencies.clear()
    for i, b in enumerate(budgets):
        svc.submit(Session(sid=i, seed=i, num_steps=b))
    reset_counts()
    t0 = time.perf_counter()
    svc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    st = svc.stats()
    if st["running"] or st["queued"] or svc.steps_served != sum(budgets):
        raise AssertionError(f"service left work: {st}")
    if launches != {"megastep": st["ticks"], "raster": 0, "flash": 0}:
        raise AssertionError(f"service launches {launches}, ticks "
                             f"{st['ticks']}")
    import numpy as np

    ids = np.arange(0, SERVICE_SLOTS, 2)
    for sid in range(SERVICE_SLOTS):
        svc.pool.admit(seed=sid)
    split = recv_split(torch, svc.pool, ids, np.ones(len(ids), np.int32))
    return {"id": SERVICE_ID, "slots": SERVICE_SLOTS,
            "recv_split_ms_half_ready": split,
            "sessions": SERVICE_SESSIONS, "steps_served": svc.steps_served,
            "steps_per_s": svc.steps_served / wall,
            "recv_p50_ms": 1e3 * st["recv_p50_s"],
            "recv_p99_ms": 1e3 * st["recv_p99_s"], "ticks": st["ticks"],
            "occupancy": svc.steps_served / (st["ticks"] * SERVICE_SLOTS),
            "wall_s": wall, "launches": launches}


RECV_SPLIT_RUNS, RECV_PROFILED = 16, 8


def recv_split(torch, pool, ids, acts, runs=RECV_SPLIT_RUNS):
    """A recv's parts, each ended by a synchronize, median ms over `runs`
    recvs of the same ready set: `_stage_ready` (the host copies of the
    ready actions and ids), `_step_ready` (the masked step, the gather and
    the pack on the card) and `_fetch` (the one copy to the host); then
    whole recvs under torch.profiler: device launches a recv (kernels and
    copies), device-busy ms and the idle share."""
    parts = {"stage": [], "step_gather_pack": [], "copy_to_host": []}
    with uncounted():
        for _ in range(runs):
            pool.send(acts, ids)
            with pool._cond:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, staged = pool._stage_ready(None)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                packed = pool._step_ready(staged)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                pool._fetch(packed)
                t3 = time.perf_counter()
            for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                parts[k].append(1e3 * dt)

        def one_recv():
            pool.send(acts, ids)
            pool.recv()

        prof = profile_window(torch, one_recv, RECV_PROFILED)
    return {**{k: statistics.median(v) for k, v in parts.items()},
            "profiled": prof}


def async_pixel_run(torch, device):
    """AsyncEnvPool(Pong-v0, 4,096) with alternate halves ready for 256
    recvs: ms per recv (host clock, the one output copy included) and
    bytes copied to the host per recv; then one recv's masked step, from
    the staged actions up to the output copy, with host syncs made
    errors."""
    import numpy as np

    from repro_torch.pool import AsyncEnvPool

    rng = np.random.default_rng(3)
    b = ASYNC_PIXEL_SLOTS
    pool = AsyncEnvPool(ASYNC_PIXEL_ID, b, device=device)
    halves = (np.arange(b // 2), np.arange(b // 2, b))
    reset_counts()
    pool.reset(seed=0)
    times, nbytes = [], []
    for i in range(ASYNC_PIXEL_RECVS):
        ids = halves[i % 2]
        pool.send(rng.integers(0, 3, len(ids)).astype(np.int32), ids)
        t0 = time.perf_counter()
        obs, rew, done, info, got = pool.recv()
        times.append(time.perf_counter() - t0)
        if obs.shape != (len(ids), 4, 84, 84) or not np.array_equal(got, ids):
            raise AssertionError(f"pixel recv gave {obs.shape}, ids {got[:4]}")
        nbytes.append(obs.nbytes + rew.nbytes + done.nbytes
                      + sum(v.nbytes for v in info.values()))
    launches = read_counts()
    want = {"megastep": ASYNC_PIXEL_RECVS,
            "raster": 2 * ASYNC_PIXEL_RECVS + 1, "flash": 0}
    if launches != want:
        raise AssertionError(f"pixel path launches {launches}, want {want}")
    with uncounted():
        pool.send(np.ones(b // 2, np.int32), halves[0])
        with pool._cond:
            ids, staged = pool._stage_ready(None)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                packed = pool._step_ready(staged)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            obs = pool._fetch(packed)[0]
        if not np.isfinite(obs).all():
            raise AssertionError("non-finite frames")
    per_recv = statistics.median(nbytes)
    split = recv_split(torch, pool, halves[0],
                       np.ones(b // 2, np.int32))
    return {"id": ASYNC_PIXEL_ID, "slots": b, "ready_per_recv": b // 2,
            "recv_split_ms": split,
            "recvs": ASYNC_PIXEL_RECVS,
            "recv_ms_median": 1e3 * statistics.median(times),
            "recv_ms_p99": 1e3 * sorted(times)[int(0.99 * (len(times) - 1))],
            "bytes_to_host_per_recv": per_recv,
            "whole_table_bytes_per_recv": per_recv * 2,
            "launches": launches, "sync_free_masked_step": True}


def phase_async(torch, device):
    from repro_torch.kernels.envstep import ops

    t0 = time.perf_counter()
    ops.fresh_rows.calls = 0
    paths = {}
    goldens = async_goldens(torch, device)
    paths["goldens"] = goldens["launches"]
    service = service_run(torch, device)
    paths["service"] = service["launches"]
    pixel = async_pixel_run(torch, device)
    paths["pixel"] = pixel["launches"]
    if fresh_rows_calls():
        raise AssertionError(f"{fresh_rows_calls()} calls of fresh_rows on "
                             "the async CUDA path")
    masked = []
    with uncounted():
        for i, env_id in enumerate(IDS + PIXEL_IDS + GRID_IDS):
            pixel_id = env_id in PIXEL_IDS
            masked.append(masked_check(
                torch, device, env_id, B_PIXEL if pixel_id else MASKED_B,
                MASKED_PIXEL_STEPS if pixel_id else MASKED_STEPS, 40 + i))
    launches = {n: sum(p[n] for p in paths.values()) for n in
                ("megastep", "raster")}
    emit({"phase": "async", "seconds": time.perf_counter() - t0,
          "goldens": {k: goldens[k] for k in ("max_abs_err", "backends")},
          "service": service, "pixel": pixel, "masked": masked,
          "launches_per_path": paths, "launches": launches})
    return launches, max(r["max_abs_err"] for r in masked)


def fault_cell(torch, device, root):
    """fig_fault.py's default cell on the megastep: supervised steps/s with
    snapshots off and every 16, and a blocking snapshot's seconds."""
    import numpy as np

    import repro_torch
    from repro_torch.runtime import RolloutSupervisor

    rng = np.random.default_rng(0)
    acts = rng.integers(0, 2, (FAULT_STEPS, FAULT_B)).astype(np.int32)
    rows, launches = {}, {"megastep": 0, "raster": 0, "flash": 0}
    for every in (0, FAULT_EVERY):
        pool = repro_torch.make_vec(FAULT_ID, FAULT_B, device=device)
        sup = RolloutSupervisor(pool, f"{root}/fault_{every}",
                                snapshot_every=every)
        sup.reset(seed=0)
        sup.step(acts[0])                 # warm, as fig_fault does
        sup.reset(seed=0)
        reset_counts()
        t0 = time.perf_counter()
        for t in range(FAULT_STEPS):
            sup.step(acts[t])
        torch.cuda.synchronize()
        sup.manager.wait()
        wall = time.perf_counter() - t0
        got = read_counts()
        if got["megastep"] != FAULT_STEPS:
            raise AssertionError(f"fault cell launches {got}")
        launches = {n: launches[n] + got[n] for n in launches}
        rows[f"snapshot_every_{every}"] = {
            "snapshots": sup.snapshots, "wall_s": wall,
            "steps_per_s": FAULT_STEPS * FAULT_B / wall}
    with uncounted():
        sup.snapshot(blocking=True)       # warm the save path
        t0 = time.perf_counter()
        for _ in range(SNAPSHOT_REPS):
            sup.snapshot(blocking=True)
        snap_s = (time.perf_counter() - t0) / SNAPSHOT_REPS
    sup.close()
    off, on = rows["snapshot_every_0"], rows[f"snapshot_every_{FAULT_EVERY}"]
    return {"id": FAULT_ID, "B": FAULT_B, "steps": FAULT_STEPS,
            "backend": pool.backend, **rows, "snapshot_s": snap_s,
            "overhead_pct": 100.0 * (1 - on["steps_per_s"]
                                     / off["steps_per_s"])}, launches


def kill_and_resume(torch, device, env_id, root):
    """An uninterrupted run and a supervised one (snapshots every 64, a
    device loss at step 96, `recover()`, the replay from step 64) at
    B = 65,536 on the megastep: the resumed steps and the final state bit
    for bit the uninterrupted run's. Also a snapshot's seconds (gather +
    np.savez) and the gather's alone."""
    import numpy as np

    import repro_torch
    from repro_torch import random as R
    from repro_torch.core.spaces import sample_batch
    from repro_torch.runtime import (DeviceLossError, FaultInjector,
                                     RolloutSupervisor)

    key = R.PRNGKey(7, device)
    space = repro_torch.make(env_id).action_space

    def step(p, t):
        out = p.step(sample_batch(space, R.fold_in(key, 1000 + t), KILL_B),
                     key=R.fold_in(key, t))
        return (out[0], out[1], out[2], out[3])

    with uncounted():
        ref_pool = repro_torch.make_vec(env_id, KILL_B, device=device)
        ref_pool.reset(seed=7)
        ref = {}
        for t in range(KILL_END):
            out = step(ref_pool, t)
            if t >= KILL_EVERY:
                ref[t] = out
        ref_final = ref_pool.state_dict()
        del ref_pool

    clk = [0.0]
    inj = FaultInjector(clock=lambda: clk[0])
    sup = RolloutSupervisor(
        repro_torch.make_vec(env_id, KILL_B, device=device),
        f"{root}/kill_{env_id}", snapshot_every=KILL_EVERY,
        blocking_snapshots=True, injector=inj)
    reset_counts()
    sup.reset(seed=7)
    t, killed, recovery_s, plan = 0, False, None, None
    while t < KILL_END:
        if t == KILL_AT and not killed:
            inj.schedule(0.5, "device_loss", 1)
            clk[0] = 1.0
        try:
            out = step(sup, t)
        except DeviceLossError:
            killed = True
            t0 = time.perf_counter()
            plan = sup.recover()
            recovery_s = time.perf_counter() - t0
            t = sup.t
            continue
        if killed and not _tree_equal(torch, out, ref[t]):
            raise AssertionError(f"{env_id}: resumed step {t} differs from "
                                 "the uninterrupted run")
        t += 1
    launches = read_counts()
    steps_run = KILL_AT + (KILL_END - KILL_EVERY)
    if not killed or plan["restored_step"] != KILL_EVERY:
        raise AssertionError(f"{env_id}: recovery {plan}")
    if launches["megastep"] != steps_run:
        raise AssertionError(f"{env_id}: {launches} for {steps_run} steps")
    if not _np_tree_equal(sup.pool.state_dict(), ref_final):
        raise AssertionError(f"{env_id}: final state differs")
    with uncounted():
        t0 = time.perf_counter()
        snap = sup.pool.state_dict()
        gather_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sup.snapshot(blocking=True)
        snap_s = time.perf_counter() - t0
    from torch.utils._pytree import tree_leaves

    sup.close()
    return {"id": env_id, "B": KILL_B, "backend": sup.pool.backend,
            "killed_at": KILL_AT, "restored_step": plan["restored_step"],
            "recovery_s": recovery_s, "snapshot_s": snap_s,
            "gather_s": gather_s,
            "snapshot_bytes": int(sum(np.asarray(x).nbytes
                                      for x in tree_leaves(snap))),
            "resumed_bit_for_bit": True}, launches


def remesh_check(torch, device, root):
    """A 2-shard ShardedEnvPool over (cuda:0, cuda:0) on the megastep, two
    launches a step, killed and recovered onto 1 shard: bit for bit a
    1-shard pool restored from the same snapshot."""
    import numpy as np

    import repro_torch
    from repro_torch import random as R
    from repro_torch.pool import ShardedEnvPool
    from repro_torch.runtime import (DeviceLossError, FaultInjector,
                                     RolloutSupervisor)

    key = R.PRNGKey(0, device)
    rng = np.random.default_rng(5)
    acts = rng.integers(0, 2, (REMESH_END, REMESH_B)).astype(np.int32)
    card = torch.device("cuda", 0) if device.type == "cuda" else device
    clk = [0.0]
    inj = FaultInjector(clock=lambda: clk[0])
    pool = ShardedEnvPool("CartPole-v1", REMESH_B, mesh=(card, card),
                          backend="cuda")
    d = f"{root}/remesh"
    sup = RolloutSupervisor(pool, d, snapshot_every=REMESH_EVERY,
                            blocking_snapshots=True, injector=inj)
    reset_counts()
    sup.reset(seed=0)
    for t in range(REMESH_KILL):
        sup.step(acts[t], key=R.fold_in(key, t))
    two = read_counts()
    if two["megastep"] != 2 * REMESH_KILL:
        raise AssertionError(f"2-shard launches {two}")
    with uncounted():
        oracle = RolloutSupervisor(
            repro_torch.make_vec("CartPole-v1", REMESH_B, device=device), d)
        oracle.restore(step=REMESH_EVERY)
        ref = [oracle.step(acts[t], key=R.fold_in(key, t))
               for t in range(REMESH_EVERY, REMESH_END)]
    inj.schedule(1.0, "device_loss", 1)
    clk[0] = 2.0
    try:
        sup.step(acts[REMESH_KILL], key=R.fold_in(key, REMESH_KILL))
        raise AssertionError("the device-loss fault did not fire")
    except DeviceLossError:
        plan = sup.recover(n_devices=1)
    reset_counts()
    got = [sup.step(acts[t], key=R.fold_in(key, t))
           for t in range(sup.t, REMESH_END)]
    one = read_counts()
    if (sup.pool.n_shards != 1 or plan["restored_step"] != REMESH_EVERY
            or one["megastep"] != REMESH_END - REMESH_EVERY):
        raise AssertionError(f"re-mesh {plan}, {one}")
    if not _tree_equal(torch, got, ref):
        raise AssertionError("the 1-shard continuation differs from the "
                             "1-shard run from the same snapshot")
    sup.close()
    return {"B": REMESH_B, "mesh_before": [str(card)] * 2,
            "mesh_after": plan["mesh"], "restored_step": plan["restored_step"],
            "bit_for_bit": True}, {n: two[n] + one[n] for n in two}


def drain_restore_check(torch, device, root):
    """EnvService drained to a checkpoint mid-serve and restored equals an
    uninterrupted oracle service, session for session (numpy default
    policies, their RNG states crossing in meta.json)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.serving import EnvService, Session

    budgets = session_budgets(DRAIN_SESSIONS, seed=1)
    mk = lambda: [Session(sid=i, seed=i, num_steps=b)
                  for i, b in enumerate(budgets)]
    svc = EnvService(SERVICE_ID, DRAIN_SLOTS, device=device)
    for s in mk():
        svc.submit(s)
    reset_counts()
    for _ in range(DRAIN_TICKS):
        svc.tick()
    with CheckpointManager(f"{root}/drain") as mgr:
        svc.drain_to_checkpoint(mgr, step=svc.ticks)
    svc2 = EnvService.restore_service(SERVICE_ID, DRAIN_SLOTS,
                                      CheckpointManager(f"{root}/drain"),
                                      mk(), device=device)
    svc2.run()
    launches = read_counts()
    with uncounted():
        oracle = EnvService(SERVICE_ID, DRAIN_SLOTS, device=device)
        for s in mk():
            oracle.submit(s)
        oracle.run()
    res = lambda s: {i: (x.steps, x.total_reward, x.episodes)
                     for i, x in s._sessions.items()}
    served = {**res(svc), **res(svc2)}    # retired before the drain: svc's
    if served != res(oracle) or len(res(svc2)) == len(budgets):
        raise AssertionError("the restored service differs from the oracle")
    return {"slots": DRAIN_SLOTS, "sessions": DRAIN_SESSIONS,
            "drained_after_ticks": DRAIN_TICKS,
            "steps_served": oracle.steps_served, "equal_to_oracle": True}, \
        launches


def cross_device_check(torch, device, root):
    """A checkpoint written from the card restored into a device="cpu"
    pool; both pools continue bit for bit on the grid body (the kernel and
    its plain twin agree bit for bit there)."""
    import numpy as np

    import repro_torch
    from repro_torch.runtime import RolloutSupervisor

    rng = np.random.default_rng(9)
    acts = rng.integers(0, 4, (2 * XDEV_STEPS, XDEV_B)).astype(np.int32)
    card = repro_torch.make_vec(XDEV_ID, XDEV_B, device=device)
    sup = RolloutSupervisor(card, f"{root}/xdev", snapshot_every=XDEV_STEPS,
                            blocking_snapshots=True)
    reset_counts()
    sup.reset(seed=4)
    for t in range(XDEV_STEPS):
        sup.step(acts[t])
    host = RolloutSupervisor(repro_torch.make_vec(XDEV_ID, XDEV_B,
                                                  device="cpu"),
                             f"{root}/xdev")
    if host.restore() != XDEV_STEPS or host.pool.device.type != "cpu":
        raise AssertionError("cross-device restore")
    for t in range(XDEV_STEPS, 2 * XDEV_STEPS):
        a, b = sup.step(acts[t]), host.step(acts[t])
        for x, y in zip(a[:3], b[:3]):
            if not torch.equal(x.cpu(), y):
                raise AssertionError(f"card and CPU pools part at step {t}")
    launches = read_counts()
    return {"id": XDEV_ID, "B": XDEV_B, "steps_after_restore": XDEV_STEPS,
            "backends": [sup.pool.backend, host.pool.backend],
            "bit_for_bit": True}, launches


def phase_runtime(torch, device):
    import shutil
    import tempfile

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    paths = {}
    try:
        fault, paths["fault"] = fault_cell(torch, device, root)
        kills = []
        for env_id in KILL_IDS:
            row, paths[f"kill_{env_id}"] = kill_and_resume(torch, device,
                                                           env_id, root)
            kills.append(row)
        remesh, paths["remesh"] = remesh_check(torch, device, root)
        drain, paths["drain"] = drain_restore_check(torch, device, root)
        xdev, paths["cross_device"] = cross_device_check(torch, device, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {n: sum(p[n] for p in paths.values()) for n in
                ("megastep", "raster")}
    emit({"phase": "runtime", "seconds": time.perf_counter() - t0,
          "fault": fault, "kill_and_resume": kills, "remesh": remesh,
          "drain_restore": drain, "cross_device": xdev,
          "launches_per_path": paths, "launches": launches})
    return launches


#: envs (slots) of each audited pool
AUDIT_BATCH = 8


def phase_audit(torch, device):
    """The port's analysis gates on the card (repro_torch.analysis): the
    cost model over every registry id on the "vmap" and "cuda" paths and
    the GOLDEN_TRAIN_IDS train steps (a JSON line a row), then the audit
    over every id × ("vmap", "cuda", "async", "sharded") and the three
    train units: each step with host syncs raising and the dispatcher
    watching its copies, the carry written in place, the async launches
    across ready sets, the train graphs free of host nodes. Raises on any
    violation, on an unexpected refusal, or on a missing row. Its launches
    are checks, not the main path's: uncounted."""
    from repro_torch.analysis import audit, cost
    from repro_torch.core.registry import registered
    from repro_torch.train.fused import GOLDEN_TRAIN_IDS

    t0 = time.perf_counter()
    keys = ("id", "backend", "status", "flops_per_step", "bytes_per_step",
            "peak_live_bytes", "arithmetic_intensity", "refusal")
    with uncounted():
        costs = cost.run(device=device, batch=AUDIT_BATCH, smoke=True,
                         progress=lambda r: emit({"cost_row": {
                             **{k: r.get(k) for k in keys},
                             "roofline_bound_s": (r.get("roofline") or {})
                             .get("bound_s"),
                             "kernels": {k: v.get("launches") for k, v in
                                         (r.get("kernels") or {}).items()}}}))
        t1 = time.perf_counter()
        report = audit.run(device=device, batch=AUDIT_BATCH, smoke=True)
    rows = report["rows"]
    want_cells = len(registered()) * len(audit.BACKENDS) + len(GOLDEN_TRAIN_IDS)
    refusals = {}
    for r in rows:
        if r["status"] == "refused":
            refusals.setdefault(r["refusal"], []).append(
                f"{r['id']}×{r['backend']}")
    train = {r["id"]: {k: r.get(k) for k in (
        "status", "graph_nodes", "node_types", "host_transfer_ops",
        "moved_leaves", "carry_leaves", "leaves_written")}
        for r in rows if r["backend"] == audit.TRAIN_BACKEND}
    out = {"phase": "audit", "seconds": time.perf_counter() - t0,
           "cost_seconds": t1 - t0, "audit_seconds": time.perf_counter() - t1,
           "summary": report["summary"], "cells": len(rows),
           "want_cells": want_cells, "refusals": refusals, "train": train,
           "async_launches": {r["id"]: r["launches_by_ready_set"]
                              for r in rows if "launches_by_ready_set" in r},
           "host_copies": sorted({c for r in rows
                                  for c in r.get("host_copies", ())}),
           "cost_summary": costs["summary"],
           "violations": report["violations"]}
    emit(out)
    bad = (report["violations"] or len(rows) != want_cells
           or costs["summary"]["unexpected_refusals"]
           or any(t["status"] != "ok" for t in train.values()))
    if bad:
        raise AssertionError(f"audit: {out['violations'][:10]}, "
                             f"{len(rows)} of {want_cells} cells, cost "
                             f"refusals {costs['summary']['unexpected_refusals']}"
                             f", train {train}")
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
    from repro_torch.kernels.envstep.megastep import cost as megastep_cost

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
        work = megastep_cost(spec.name, b, k, sp, spec.obs_size, resets)
        nbytes, int_ops, float_ops = (work["bytes"], work["int_ops"],
                                      work["float_ops"])
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

#: head layouts of the LM configs the port runs: (query heads, KV heads,
#: q/k head dim, v head dim); MiniCPM3-4B's MLA attends with q and k of
#: nope + rope = 96 and v of v_head_dim = 64 (its naive form)
YI_HEADS, DANUBE_HEADS = (32, 4, 128, 128), (32, 8, 80, 80)
MINICPM3_HEADS = (40, 40, 96, 64)
OLMOE_HEADS, GRANITE_HEADS = (16, 16, 128, 128), (16, 8, 64, 64)
#: zamba2-2.7B's shared attention (32/32 heads of 80); whisper-base's
#: encoder, decoder self- and cross-attention (8/8 heads of 64)
ZAMBA2_HEADS, WHISPER_HEADS = (32, 32, 80, 80), (8, 8, 64, 64)
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
#: (case, heads, B, Lq, Lk, causal, window, q_offset, timed); each runs in
#: bf16 and f32. `timed` names the path whose shape a case times beside its
#: bound (and SDPA where it computes the same function), else None: "lm"
#: (a 2,048-token prompt prefilled against Yi-6B's 4,096-slot cache: the
#: kernels line's shape), "window" (Danube's), "mla" (MiniCPM3-4B's
#: prefill: the kernels line's minicpm3_heads), "whisper" (whisper-base's
#: encoder over 1,500 frames, batch 4, non-causal: the kernels line's
#: whisper_heads), "train" (h2o-danube-1.8b's training forward, 4 × 2,048
#: tokens, its 4,096 window wider than the sequence: the kernels line's
#: danube_train_heads). The MoE paths' heads, OLMoE-1B-7B's (16, 16, 128) and
#: Granite-MoE's (16, 8, 64), are checked at a prefill, a ragged prompt and
#: a decode; zamba2's at a prefill and a decode; Whisper's decoder at its
#: prompt and decode steps over the 1,500 frames (cross) and its
#: WHISPER_MAX_SEQ cache (self)
ATTN_CASES = (
    ("causal over a full cache", YI_HEADS, 1, 2048, 4096, True, 0, 0, "lm"),
    ("causal over a full cache", DANUBE_HEADS, 1, 2048, 4096, True, 0, 0, None),
    ("ragged prompt", YI_HEADS, 1, 37, 4096, True, 0, 0, None),
    ("ragged prompt", DANUBE_HEADS, 1, 37, 4096, True, 0, 0, None),
    ("decode", YI_HEADS, 1, 1, 4096, True, 0, 3000, None),
    ("decode", DANUBE_HEADS, 1, 1, 4096, True, 0, 3000, None),
    ("window", DANUBE_HEADS, 1, 4608, 4608, True, 4096, 0, "window"),
    ("non-causal", YI_HEADS, 1, 1024, 1024, False, 0, 0, None),
    ("non-causal", DANUBE_HEADS, 1, 1024, 1024, False, 0, 0, None),
    ("B = 2, offset prompt", YI_HEADS, 2, 333, 4096, True, 0, 100, None),
    ("causal over a full cache", MINICPM3_HEADS, 1, 2048, 4096, True, 0, 0, "mla"),
    ("ragged prompt", MINICPM3_HEADS, 1, 37, 4096, True, 0, 0, None),
    ("decode", MINICPM3_HEADS, 1, 1, 4096, True, 0, 3000, None),
    ("causal over a full cache", OLMOE_HEADS, 1, 2048, 4096, True, 0, 0, None),
    ("ragged prompt", OLMOE_HEADS, 1, 37, 4096, True, 0, 0, None),
    ("decode", OLMOE_HEADS, 1, 1, 4096, True, 0, 3000, None),
    ("causal over a full cache", GRANITE_HEADS, 1, 2048, 4096, True, 0, 0, None),
    ("ragged prompt", GRANITE_HEADS, 1, 37, 4096, True, 0, 0, None),
    ("decode", GRANITE_HEADS, 1, 1, 4096, True, 0, 3000, None),
    ("causal over a full cache", ZAMBA2_HEADS, 1, 2048, 4096, True, 0, 0, None),
    ("decode", ZAMBA2_HEADS, 1, 1, 4096, True, 0, 3000, None),
    ("encoder, non-causal", WHISPER_HEADS, 4, 1500, 1500, False, 0, 0, "whisper"),
    ("cross attention, prompt", WHISPER_HEADS, 4, 64, 1500, False, 0, 0, None),
    ("cross attention, decode", WHISPER_HEADS, 4, 1, 1500, False, 0, 0, None),
    ("decode", WHISPER_HEADS, 4, 1, 448, True, 0, 100, None),
    ("training", DANUBE_HEADS, 4, 2048, 2048, True, 4096, 0, "train"),
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
#: a prime prompt length of lm_prompts (seed 0): the GLA scan takes chunk 1
PRIME_PROMPT = 1109
#: MiniCPM3-4B at full width and depth (MLA, its naive form): prompts of
#: 2,048 tokens prefilled into a SERVE_MAX_SEQ cache, then greedy
#: decode steps at a scalar position (the engine cannot serve MLA:
#: serving/engine.py::check_servable)
MLA_BATCH, MLA_PROMPT, MLA_DECODES = 4, 2048, 64
#: the MoE invariant's prompt in f32: with at most 8 tokens a group no
#: expert can overflow (moe_capacity is at least 8), so forward(L + 1) and
#: prefill(L) + decode drop nothing and must agree; at INVARIANT_L in bf16
#: the two paths' routing can differ by design (other product shapes round
#: the router logits otherwise, and capacity drops differ), so that error
#: is reported beside the count of routings that differ, not gated
MOE_F32_L = 7


def attention_work(b, heads, lq, lk, causal, window, q_offset, itemsize):
    """(live query-key pairs, bytes, flops) of one attention call
    (kernels/attention/flash.py::cost): each row's visible keys counted, Q,
    O and the live K and V moved once, 2·(D + Dv) flops a live pair."""
    from repro_torch.kernels.attention.flash import cost

    c = cost(b, heads, lq, lk, causal, window, q_offset, itemsize)
    return c["live_pairs"], c["bytes"], c["flops"]


def attention_inputs(torch, heads, b, lq, lk, dtype, seed, device):
    hq, hkv, d, dv = heads
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda h, l, w: torch.randn((b, h, l, w), generator=g,
                                     device=device).to(dtype)
    return mk(hq, lq, d), mk(hkv, lk, d), mk(hkv, lk, dv)


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


def attention_cases(torch, device, table, bw, fp32_flops, bf16_flops,
                    seed0=0):
    """Each case of `table` (ATTN_CASES' layout) in bf16 and f32: the kernel
    against attention_ref (attention_check), and at the timed cases the
    kernel, plain and library times beside the bound (the window's in bf16
    only). SDPA is the library call where it computes the same function: at
    q_offset 0 (its is_causal mask is top-left aligned) and, for a causal
    decode row, non-causal over the keys the row sees. Returns (cases, worst
    error, {timed name: its bf16 case})."""
    import torch.nn.functional as F

    from repro_torch.kernels.attention import attention_ref, flash_attention_cuda

    cases, worst, timed_bf16 = [], 0.0, {}
    with uncounted():
        for i, (what, heads, b, lq, lk, causal, window, q_offset,
                timed_as) in enumerate(table):
            for dtype in (torch.bfloat16, torch.float32):
                name = str(dtype).split(".")[-1]
                q, k, v = attention_inputs(torch, heads, b, lq, lk, dtype,
                                           seed0 + i, device)
                kw = dict(causal=causal, window=window, q_offset=q_offset)
                checked = attention_check(torch, q, k, v, what, **kw)
                worst = max(worst, checked["max_abs_err"])
                case = {"case": what, "dtype": name, "heads": heads, "B": b,
                        "Lq": lq, "Lk": lk, "causal": causal,
                        "window": window, "q_offset": q_offset,
                        "tol": ATTN_TOL[name], **checked}
                if timed_as and (timed_as != "window"
                                 or dtype == torch.bfloat16):
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
                    sdpa = None
                    if q_offset == 0 and (not window or window >= lk):
                        # is_causal is top-left aligned: key j <= row i, the
                        # same mask as q_offset 0 (and as a window no
                        # shorter than the keys)
                        sdpa = lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=causal, enable_gqa=True)
                    elif lq == 1 and causal and not window:
                        # one decode row sees keys 0..q_offset, all of them
                        seen = min(lk, q_offset + 1)
                        ks, vs = k[:, :, :seen], v[:, :, :seen]
                        sdpa = lambda: F.scaled_dot_product_attention(
                            q, ks, vs, enable_gqa=True)
                    if sdpa is not None:
                        case["library"] = ("torch.nn.functional."
                                           "scaled_dot_product_attention")
                        case["library_ms"] = event_ms(torch, sdpa, 20)
                        case["library_max_abs_err"] = float(
                            (sdpa().float() - attention_ref(q, k, v, **kw)
                             .float()).abs().max())
                    if dtype == torch.bfloat16:
                        timed_bf16[timed_as] = case
                cases.append(case)
                del q, k, v
    torch.cuda.empty_cache()
    return cases, worst, timed_bf16


def phase_attention(torch, device, bw, fp32_flops, bf16_flops):
    """The CUDA flash attention against attention_ref at the LM paths'
    shapes; kernel, plain and SDPA times and the bound at the timed cases
    (the window's in bf16 only). Returns (worst error, {timed name: its
    bf16 case})."""
    t0 = time.perf_counter()
    cases, worst, timed_bf16 = attention_cases(torch, device, ATTN_CASES, bw,
                                               fp32_flops, bf16_flops)
    emit({"phase": "attention", "seconds": time.perf_counter() - t0,
          "cases": cases, "clock": "CUDA events: kernel and SDPA over 20 "
          "launches, plain over 3", "rates": {"bytes_per_s": bw,
                                              "bf16_flops": bf16_flops,
                                              "fp32_flops": fp32_flops}})
    return worst, timed_bf16


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


def real_layer_checks(torch, lm, cfg, params, toks, calls=None, frames=None,
                      max_seq=SERVE_MAX_SEQ):
    """The kernel against the plain version on the real q, k and v of the
    attention calls `calls` ({call number: name}; the first and last layers
    when None) of one prefill of `toks` (with Whisper's `frames`) into a
    `max_seq` cache. Returns {"<arch> <name>": shapes, kwargs and errors}."""
    calls = calls or {0: "layer 0", cfg.num_layers - 1:
                      f"layer {cfg.num_layers - 1}"}
    batch = {"tokens": toks} if frames is None else {"tokens": toks,
                                                      "frames": frames}
    with captured_attention(set(calls)) as seen:
        lm.prefill(cfg, params, batch, max_seq)
    if set(seen) != set(calls):
        raise AssertionError(f"{cfg.name}: attention calls {sorted(seen)} "
                             f"captured, want {sorted(calls)}")
    real = {}
    for layer, (q, k, v, kw) in sorted(seen.items()):
        what = f"{cfg.name} {calls[layer]}"
        real[what] = {"q": list(q.shape), "k": list(k.shape),
                      "v": list(v.shape), **kw,
                      **attention_check(torch, q, k, v, what, **kw)}
    return real


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


def decode_vs_forward(lm, cfg, params, toks, backend, frames=None):
    """(decode_step logits at L after prefill(L), forward(L + 1)'s last
    logits), every attention routed to `backend`; an encoder-decoder
    model's batches carry `frames`."""
    l = toks.shape[1] - 1
    extra = {} if frames is None else {"frames": frames}
    with captured_attention(set(), backend):
        hidden, _ = lm.forward(cfg, params, {"tokens": toks, **extra})
        ref = lm.logits_for(cfg, params, hidden[:, -1:])[:, 0]
        _, caches = lm.prefill(cfg, params, {"tokens": toks[:, :l], **extra},
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


@contextlib.contextmanager
def timed_prefills(lm):
    """Record (prompt length, seconds) of every `lm.prefill` call inside
    the block, each between two synchronizes (the engine's admit ends each
    in a host copy of its token anyway)."""
    import torch

    original, seen = lm.prefill, []

    def spy(cfg, params, batch, max_seq):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(cfg, params, batch, max_seq)
        torch.cuda.synchronize()
        seen.append((int(batch["tokens"].shape[1]), time.perf_counter() - t0))
        return out

    lm.prefill = spy
    try:
        yield seen
    finally:
        lm.prefill = original


def attention_sites(cfg):
    """The GQA attention calls of one prefill: every block but the
    recurrent ones."""
    from repro_torch.models.stack import SSM_KINDS

    return sum(rep * sum(kind not in SSM_KINDS for kind in blocks)
               for blocks, rep in cfg.segments)


def serve_cell(torch, lm, engine, prompts):
    """The serving path of one model: a warm-up prefill and decode
    (uncounted), then every prompt through `serve_requests` with the launch
    counts set to 0 just before and read just after (one flash launch per
    attention layer per prefill). Returns its numbers, each prefill's
    seconds among them; raises on other counts or a request without its
    tokens."""
    cfg, device = engine.cfg, engine.device
    eparams = engine.params
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
    with timed_prefills(lm) as prefills:
        reqs, seconds, first, ticks = serve_requests(torch, engine, prompts)
    launches = read_counts()
    want = {"megastep": 0, "raster": 0,
            "flash": len(prompts) * attention_sites(cfg)}
    if launches != want:
        raise AssertionError(f"{cfg.name} serving: launches {launches}, "
                             f"want {want}")
    for r in reqs:
        if len(r.output) != SERVE_NEW or not all(
                0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.rid}: {len(r.output)} tokens, "
                                 f"want {SERVE_NEW} in [0, {cfg.vocab_size})")
    ttft = sorted(first.values())
    decode_ticks = [s for s, n in ticks if n == 0]
    generated = sum(len(r.output) for r in reqs)
    return {
        "arch": cfg.name, "slots": engine.slots, "max_seq": engine.max_seq,
        "requests": len(prompts), "max_new_tokens": SERVE_NEW,
        "prompt_tokens": int(sum(len(p) for p in prompts)),
        "prompt_lens": [len(p) for p in prompts],
        "seconds": seconds, "generated_tokens": generated,
        "tokens_per_s": generated / seconds,
        "ttft_s_median": statistics.median(ttft), "ttft_s_max": ttft[-1],
        "ticks": len(ticks), "decode_tick_ms_median":
            1e3 * statistics.median(decode_ticks) if decode_ticks else None,
        "admit_ticks_s": sum(s for s, n in ticks if n),
        "prefill_s": [{"L": n, "s": sec} for n, sec in prefills],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "stats": engine.stats(),
        "clock": "host clock; each tick ends in the tokens' host copy, so "
                 "a first token is stamped at the end of its tick"}


def check_decode_vs_forward(torch, lm, cfg, eparams, toks, frames=None,
                            bf16_ungated=None):
    """tests/test_models.py::test_decode_matches_forward through the
    kernel: prefill(L) + decode_step(L) against forward(L + 1) on `toks`
    (1, L + 1), in the compute dtype (bf16) through the kernel and the plain
    attention, and in f32 (params upcast from `eparams`) through the
    kernel. Emits and returns the errors; raises past F32_LOGIT_TOL in f32
    or BF16_LOGIT_REL in bf16 (the kernel's, and the kernel's decode
    against the plain one's). With `bf16_ungated` (the reason) the bf16
    decode against forward is reported, not gated."""
    import dataclasses

    logits = {"bfloat16 kernel": decode_vs_forward(lm, cfg, eparams, toks,
                                                   "auto", frames),
              "bfloat16 plain": decode_vs_forward(lm, cfg, eparams, toks,
                                                  "torch", frames)}
    p32 = lm.tree_map(lambda x: x.float(), eparams)
    logits["float32 kernel"] = decode_vs_forward(
        lm, dataclasses.replace(cfg, dtype="float32"), p32, toks, "auto",
        frames)
    del p32
    inv = {what: logit_errors(*pair) for what, pair in logits.items()}
    inv["bfloat16 kernel against plain, decode"] = logit_errors(
        logits["bfloat16 kernel"][0], logits["bfloat16 plain"][0])
    out = {"arch": cfg.name, "L": toks.shape[1] - 1, "f32_tol": F32_LOGIT_TOL,
           "bf16_rel_l2_tol": BF16_LOGIT_REL,
           "max_abs_logit": float(logits["bfloat16 kernel"][1].abs().max()),
           **inv}
    if bf16_ungated:
        out["bfloat16 kernel"]["gated"] = False
        out["bfloat16 ungated, why"] = bf16_ungated
    emit({"check": "decode_matches_forward", **out})
    got, ref = logits["float32 kernel"]
    torch.testing.assert_close(
        got, ref, rtol=F32_LOGIT_TOL, atol=F32_LOGIT_TOL,
        msg=lambda m: f"{cfg.name} f32 decode != forward: {m}")
    gated = ["bfloat16 kernel against plain, decode"]
    gated += [] if bf16_ungated else ["bfloat16 kernel"]
    for what in gated:
        if not inv[what]["rel_l2"] <= BF16_LOGIT_REL:
            raise AssertionError(f"{cfg.name} decode != forward ({what}): "
                                 f"{inv[what]}")
    return out


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
    out["serve"] = serve_cell(torch, lm, engine, prompts)
    del engine.state
    gc.collect()
    torch.cuda.empty_cache()

    errs = []
    with uncounted():
        toks = torch.from_numpy(np.resize(prompts[1], INVARIANT_L + 1)).to(
            device)[None].long()
        out["decode_matches_forward"] = check_decode_vs_forward(
            torch, lm, cfg, eparams, toks)

        # the kernel on the real q, k and v of layers 0 and 31 of one
        # 2,048-token prefill
        toks = torch.from_numpy(np.resize(prompts[2], REAL_PROMPT)).to(device)[None]
        real = real_layer_checks(torch, lm, cfg, eparams, toks)
        errs += [c["max_abs_err"] for c in real.values()]
        del eparams, engine
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


@contextlib.contextmanager
def recorded_routing():
    """Record the expert ids (`moe.top_k`'s idx) of every moe_apply call
    inside the block, in call order."""
    from repro_torch.models import moe

    original, seen = moe.top_k, []

    def spy(logits, k):
        values, idx = original(logits, k)
        seen.append(idx.clone())
        return values, idx

    moe.top_k = spy
    try:
        yield seen
    finally:
        moe.top_k = original


@contextlib.contextmanager
def replayed_routing(recorded):
    """Route the moe_apply calls inside the block, in call order, to the
    expert ids `recorded` (by recorded_routing), each call's gate logits
    read from its own router logits at those ids; raises unless every
    recorded routing was replayed."""
    import torch

    from repro_torch.models import moe

    original, calls = moe.top_k, iter(recorded)

    def spy(logits, k):
        idx = next(calls)
        return torch.gather(logits, -1, idx), idx

    moe.top_k = spy
    try:
        yield
    finally:
        moe.top_k = original
    if next(calls, None) is not None:
        raise AssertionError("fewer moe_apply calls than routings recorded")


def routed_pair(lm, cfg, params, toks):
    """decode_vs_forward through the kernel, recording every routing, and
    through the plain attention with those routings replayed, so that the
    two differ only where the kernel and the plain attention do. Returns
    (the kernel's (decode, forward) logits, the plain's, the routings)."""
    with recorded_routing() as seen:
        kernel = decode_vs_forward(lm, cfg, params, toks, "auto")
    with replayed_routing(seen):
        plain = decode_vs_forward(lm, cfg, params, toks, "torch")
    return kernel, plain, seen


def moe_checks(torch, lm, cfg, eparams, toks):
    """decode against forward for a MoE model, and the kernel against the
    plain attention on the same routings (routed_pair). In f32 on a
    MOE_F32_L-token prompt (no drops possible): decode against forward and
    the kernel's decode against the plain one's, both gated at
    F32_LOGIT_TOL. In the compute dtype on `toks` (1, INVARIANT_L + 1): the
    kernel's decode and forward against the plain ones', gated at
    BF16_LOGIT_REL as check_decode_vs_forward gates them; decode against
    forward through the kernel reported, not gated, beside the number of
    (layer, token) routings whose top-k experts differ between
    forward(L + 1) and prefill(L) + decode, and the entries each drops past
    its capacity (forward may drop the last token, which a one-token
    decode never drops)."""
    import dataclasses

    from repro_torch.models import moe

    p32 = lm.tree_map(lambda x: x.float(), eparams)
    (got, ref), (plain, _), _ = routed_pair(
        lm, dataclasses.replace(cfg, dtype="float32"), p32,
        toks[:, :MOE_F32_L + 1])
    del p32
    out = {"arch": cfg.name, "f32_L": MOE_F32_L, "f32_tol": F32_LOGIT_TOL,
           "bf16_rel_l2_tol": BF16_LOGIT_REL,
           "float32 kernel": logit_errors(got, ref),
           "float32 kernel against plain, decode": logit_errors(got, plain)}
    for what, want in (("decode != forward", ref), ("kernel != plain", plain)):
        torch.testing.assert_close(
            got, want, rtol=F32_LOGIT_TOL, atol=F32_LOGIT_TOL,
            msg=lambda m: f"{cfg.name} f32 {what}: {m}")
    (got, ref), (plain, plain_ref), seen = routed_pair(lm, cfg, eparams, toks)
    for what, pair in (("decode", (got, plain)), ("forward", (ref, plain_ref))):
        out[f"bfloat16 kernel against plain, {what}"] = errs = logit_errors(*pair)
        if not errs["rel_l2"] <= BF16_LOGIT_REL:
            raise AssertionError(f"{cfg.name} bf16 kernel != plain ({what}):"
                                 f" {errs}")
    n = cfg.num_layers
    if len(seen) != 3 * n:
        raise AssertionError(f"{cfg.name}: {len(seen)} routings, want {3 * n}")
    fwd = torch.stack([x[0].sort(-1).values for x in seen[:n]])
    cached = torch.stack([torch.cat([a[0], b[0]]).sort(-1).values
                          for a, b in zip(seen[n:2 * n], seen[2 * n:])])
    differ = (fwd != cached).any(-1)                   # (layers, L + 1)

    def drops(idx):
        """(entries past the capacity, whether the last token's are among
        them) of one routing: ranks follow token order within an expert."""
        counts = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts)
        over = counts - moe.moe_capacity(idx.shape[1], cfg)
        return int(over.clamp_min(0).sum()), bool((over[idx[0, -1]] > 0).any())

    fwd_drops = [drops(x) for x in seen[:n]]
    out["bfloat16 kernel"] = {
        "L": toks.shape[1] - 1, **logit_errors(got, ref),
        "max_abs_logit": float(ref.abs().max()),
        "routings_differ": int(differ.sum()),
        "routings": differ.numel(),
        "tokens_with_a_routing_differing": int(differ.any(0).sum()),
        "last_token_layers_differ": int(differ[:, -1].sum()),
        "forward_entries_dropped": sum(d for d, _ in fwd_drops),
        "prefill_entries_dropped": sum(drops(x)[0] for x in seen[n:2 * n]),
        "forward_layers_dropping_the_last_token": sum(l for _, l in fwd_drops),
        "gated": False}
    emit({"check": "moe_decode_matches_forward", **out})
    return out


def phase_mla(torch, device):
    """MiniCPM3-4B at full width and depth (random params from a seed):
    lm.prefill of MLA_BATCH prompts of MLA_PROMPT tokens into a
    SERVE_MAX_SEQ cache, then MLA_DECODES greedy lm.decode_step calls at a
    scalar position, with the launch counts set to 0 just before the
    prefill and read just after the last step (one flash launch per layer
    per prefill and per step: the naive form attends through the (96, 64)
    instantiation); the decode-matches-forward invariant through the
    kernel; the kernel on the real q, k and v of the first and last
    layers."""
    import gc

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm

    t0 = time.perf_counter()
    cfg = get_config("minicpm3-4b")
    params = lm.init_params(
        cfg, torch.Generator(device=device).manual_seed(LM_SEED), device)
    out = {"phase": "mla", "arch": cfg.name, "layers": cfg.num_layers,
           "params": sum(x.numel() for x in lm.tree_leaves(params))}
    eparams = lm.compute_params(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(LM_SEED + 2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (MLA_BATCH, MLA_PROMPT))).to(device)

    out["run"] = mla_decode_run(torch, lm, cfg, eparams, toks)
    gc.collect()
    torch.cuda.empty_cache()

    errs = []
    with uncounted():
        out["decode_matches_forward"] = check_decode_vs_forward(
            torch, lm, cfg, eparams, toks[:1, :INVARIANT_L + 1].long())
        real = real_layer_checks(torch, lm, cfg, eparams, toks[:1])
        errs += [c["max_abs_err"] for c in real.values()]
    out["real_layer_checks"] = real
    del eparams
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return max(errs), out


#: MiniCPM3-4B's absorbed MLA attention: 40 query heads over the one
#: latent KV head, q and k of kv_lora_rank + rope = 288, v of kv_lora_rank
#: = 256 (models/attention.py::mla_apply with cfg.mla_absorb)
ABSORBED_HEADS = (40, 1, 288, 256)
#: its cases, ATTN_CASES' layout: the prefill (the kernels line's
#: absorbed_heads), a ragged prompt and a decode row (absorbed_decode)
ABSORBED_CASES = (
    ("causal over a full cache", ABSORBED_HEADS, 1, 2048, 4096, True, 0, 0,
     "absorbed"),
    ("ragged prompt", ABSORBED_HEADS, 1, 37, 4096, True, 0, 0, None),
    ("decode", ABSORBED_HEADS, 1, 1, 4096, True, 0, 3000, "absorbed_decode"),
)
#: prompt length of the absorbed-against-naive logits check
ABSORBED_CHECK_L = 256


def mla_decode_run(torch, lm, cfg, eparams, toks):
    """lm.prefill of `toks` into a SERVE_MAX_SEQ cache, then MLA_DECODES
    greedy lm.decode_step calls at a scalar position, with the launch
    counts set to 0 just before the prefill and read just after the last
    step; raises unless it launched exactly one flash kernel a layer per
    prefill and per step, and on non-finite logits or tokens out of the
    vocabulary. Host-clock times, each part ending in a synchronize."""
    with uncounted():  # warm cuBLAS and the kernel's library
        logits, caches = lm.prefill(cfg, eparams,
                                    {"tokens": toks[:, :PROMPT_LENS[0]]},
                                    SERVE_MAX_SEQ)
        lm.decode_step(cfg, eparams, caches,
                       logits[:, -1].argmax(-1).to(torch.int32)[:, None],
                       PROMPT_LENS[0])
        del logits, caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    t1 = time.perf_counter()
    logits, caches = lm.prefill(cfg, eparams, {"tokens": toks}, SERVE_MAX_SEQ)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    generated = [tok]
    prompt = toks.shape[1]
    for step in range(MLA_DECODES):
        lg, caches = lm.decode_step(cfg, eparams, caches, tok, prompt + step)
        tok = lg.argmax(-1).to(torch.int32)[:, None]
        generated.append(tok)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = read_counts()
    want = {"megastep": 0, "raster": 0,
            "flash": cfg.num_layers * (1 + MLA_DECODES)}
    if launches != want:
        raise AssertionError(f"{cfg.name} (mla_absorb={cfg.mla_absorb}): "
                             f"launches {launches}, want {want}")
    generated = torch.cat(generated, dim=1)
    if not (bool(torch.isfinite(lg).all()) and bool(
            ((generated >= 0) & (generated < cfg.vocab_size)).all())):
        raise AssertionError(f"{cfg.name}: non-finite logits or tokens out "
                             "of the vocabulary")
    run = {
        "mla_absorb": cfg.mla_absorb, "batch": toks.shape[0],
        "prompt": prompt, "max_seq": SERVE_MAX_SEQ,
        "decode_steps": MLA_DECODES, "generated_tokens": generated.numel(),
        "seconds": t3 - t1, "prefill_s": t2 - t1,
        "decode_step_ms": 1e3 * (t3 - t2) / MLA_DECODES,
        "tokens_per_s": generated.numel() / (t3 - t1),
        "decode_tokens_per_s": toks.shape[0] * MLA_DECODES / (t3 - t2),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "clock": "host clock; prefill and decode each end in a synchronize"}
    del logits, lg, caches
    return run


def phase_absorbed(torch, device, bw, fp32_flops, bf16_flops,
                   naive_decode_ms=None):
    """MLA's absorbed form. The (288, 256) flash instantiation against
    attention_ref at MiniCPM3-4B's heads (ABSORBED_CASES, bf16 and f32),
    with kernel, plain and SDPA times beside the bound; then MiniCPM3-4B at
    full width and depth with mla_absorb=True (random params from the seed
    of phase mla): MLA_BATCH prompts of MLA_PROMPT tokens and MLA_DECODES
    decode steps through the kernel with exact launch counts, the decode
    step's time beside the naive form's (`naive_decode_ms`, phase mla of
    the same run); the absorbed logits against the naive form's on one
    prompt. Returns (worst kernel error, out)."""
    import dataclasses
    import gc

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm

    t0 = time.perf_counter()
    cases, worst, timed_bf16 = attention_cases(
        torch, device, ABSORBED_CASES, bw, fp32_flops, bf16_flops, seed0=100)
    out = {"phase": "absorbed", "cases": cases, "timed": timed_bf16,
           "kernel_s": time.perf_counter() - t0}

    naive = get_config("minicpm3-4b")
    cfg = dataclasses.replace(naive, mla_absorb=True)
    params = lm.init_params(
        cfg, torch.Generator(device=device).manual_seed(LM_SEED), device)
    eparams = lm.compute_params(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(LM_SEED + 2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (MLA_BATCH, MLA_PROMPT))).to(device)
    out["run"] = mla_decode_run(torch, lm, cfg, eparams, toks)
    out["run"]["naive_decode_step_ms"] = naive_decode_ms
    gc.collect()
    torch.cuda.empty_cache()

    # the two forms compute one function: their logits on one prompt
    with uncounted(), torch.no_grad():
        short = {"tokens": toks[:1, :ABSORBED_CHECK_L]}
        got, _ = lm.prefill(cfg, eparams, short, SERVE_MAX_SEQ)
        ref, _ = lm.prefill(naive, eparams, short, SERVE_MAX_SEQ)
    out["absorbed_vs_naive_logits"] = {
        **logit_errors(got, ref), "L": ABSORBED_CHECK_L,
        "bf16_rel_l2_tol": BF16_LOGIT_REL}
    if not out["absorbed_vs_naive_logits"]["rel_l2"] <= BF16_LOGIT_REL:
        raise AssertionError(f"minicpm3-4b absorbed != naive: "
                             f"{out['absorbed_vs_naive_logits']}")
    del eparams, got, ref
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return worst, out


def phase_moe(torch, device):
    """OLMoE-1B-7B at full width and depth (random params from a seed)
    through ServeEngine(slots=8, max_seq=4096): the requests of phase lm,
    with the launch counts set to 0 just before run and read just after
    (one flash launch per layer per prefill); moe_checks; the kernel on the
    real q, k and v of the first and last layers of one prefill. Then
    granite-moe-1b-a400m at full width and depth as a correctness cell:
    moe_checks and the real layers. Returns (the real layers' worst
    error, the phase's numbers)."""
    import gc

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServeEngine

    t0 = time.perf_counter()
    cfg = get_config("olmoe-1b-7b")
    params = lm.init_params(
        cfg, torch.Generator(device=device).manual_seed(LM_SEED), device)
    out = {"phase": "moe", "arch": cfg.name,
           "params": sum(x.numel() for x in lm.tree_leaves(params))}
    engine = ServeEngine(cfg, params, slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                         device=device)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    prompts = lm_prompts(cfg.vocab_size)
    out["serve"] = serve_cell(torch, lm, engine, prompts)
    eparams = engine.params
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(LM_SEED + 3)
    with uncounted():
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (1, INVARIANT_L + 1))).to(device)
        out["decode_matches_forward"] = moe_checks(torch, lm, cfg, eparams, toks)
        real = real_layer_checks(torch, lm, cfg, eparams, torch.from_numpy(
            np.resize(prompts[2], REAL_PROMPT)).to(device)[None])
    del eparams
    gc.collect()
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    cfg = get_config("granite-moe-1b-a400m")
    eparams = lm.compute_params(cfg, lm.init_params(
        cfg, torch.Generator(device=device).manual_seed(LM_SEED), device))
    with uncounted():
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (1, INVARIANT_L + 1))).to(device)
        out["granite"] = moe_checks(torch, lm, cfg, eparams, toks)
        real.update(real_layer_checks(torch, lm, cfg, eparams, torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (1, REAL_PROMPT))).to(device)))
    out["granite"]["seconds"] = time.perf_counter() - t1
    out["real_layer_checks"] = real
    del eparams
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return max(c["max_abs_err"] for c in real.values()), out


#: the recurrent families, each at full width and depth through
#: ServeEngine at phase lm's settings and requests
SSM_ARCHS = ("zamba2-2.7b", "xlstm-350m")
#: xLSTM-350M's bf16 decode against forward is reported, not gated: with
#: random weights its 24 blocks carry bf16's rounding far (its bf16
#: forward is 0.54 of the logits' norm from its f32 forward, in the JAX
#: package as in the port, CPU, 64 tokens), and the JAX package's own bf16
#: decode is 0.20 of the norm from its forward there. f32 is gated.
BF16_UNGATED = {"xlstm-350m": "bf16 rounding, amplified over 24 random-weight "
                "blocks: the JAX package's own bf16 decode is 0.20 of the "
                "norm from its forward (CPU, 64 tokens); f32 gated"}
#: whisper-base at full width and depth: WHISPER_BATCH requests of 1,500
#: frames (the config's encoder_len) and a WHISPER_PROMPT-token decoder
#: prompt, prefilled into a WHISPER_MAX_SEQ self-attention cache (Whisper's
#: decoder context), then WHISPER_DECODES greedy steps at a scalar position
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_DECODES, WHISPER_MAX_SEQ = 4, 64, 64, 448


def clone_tree(tree):
    """A copy of a cache tree (lists, dicts, NamedTuples of tensors)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(clone_tree(v) for v in tree))
    return tree.clone()


def scalar_vs_per_slot(torch, lm, cfg, eparams, toks):
    """phase lm's danube check on a recurrent model: one prefill of `toks`
    (1, L), then decode_step from two copies of its caches, at the scalar
    position L and at the per-slot position [L]. The recurrent blocks
    ignore positions: with no attention block the two are equal bit for
    bit; zamba2's shared-attention sites attend per slot through the plain
    f32 einsum and at a scalar position through the kernel, gated at
    BF16_LOGIT_REL of the logits' norm. Returns the errors."""
    l = toks.shape[1]
    logits, caches = lm.prefill(cfg, eparams, {"tokens": toks}, SERVE_MAX_SEQ)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    scalar, _ = lm.decode_step(cfg, eparams, clone_tree(caches), tok, l)
    pos = torch.tensor([l], dtype=torch.int32, device=toks.device)
    per_slot, _ = lm.decode_step(cfg, eparams, caches, tok, pos)
    out = {"L": l, **logit_errors(per_slot, scalar),
           "exact": bool(torch.equal(per_slot, scalar))}
    if attention_sites(cfg) == 0 and not out["exact"]:
        raise AssertionError(f"{cfg.name}: per-slot decode != scalar: {out}")
    if not out["rel_l2"] <= BF16_LOGIT_REL:
        raise AssertionError(f"{cfg.name}: per-slot decode != scalar: {out}")
    return out


def phase_ssm(torch, device):
    """zamba2-2.7B and xLSTM-350M at full width and depth (random params
    from a seed) through ServeEngine(slots=8, max_seq=4096): the requests of
    phase lm, with the launch counts set to 0 just before run and read just
    after (one flash launch per shared-attention site per prefill: 6 for
    zamba2, none for xLSTM), each prefill's seconds beside its GLA chunk;
    then decode against forward (check_decode_vs_forward; BF16_UNGATED),
    scalar against per-slot decode, and for zamba2 the kernel on the real
    q, k and v of its first and last shared-attention sites. Returns (the
    real layers' worst error, the phase's numbers)."""
    import gc

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.models.gla import chunk_size
    from repro_torch.serving.engine import ServeEngine

    t0 = time.perf_counter()
    out, real = {"phase": "ssm"}, {}
    for arch in SSM_ARCHS:
        t1 = time.perf_counter()
        cfg = get_config(arch)
        params = lm.init_params(
            cfg, torch.Generator(device=device).manual_seed(LM_SEED), device)
        cell = {"blocks": cfg.num_layers,
                "params": sum(x.numel() for x in lm.tree_leaves(params))}
        engine = ServeEngine(cfg, params, slots=SERVE_SLOTS,
                             max_seq=SERVE_MAX_SEQ, device=device)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        cell["init_s"] = time.perf_counter() - t1
        prompts = lm_prompts(cfg.vocab_size)
        cell["serve"] = serve = serve_cell(torch, lm, engine, prompts)
        for row in serve["prefill_s"]:
            row["chunk"] = chunk_size(row["L"], cfg.ssm_chunk)
        eparams = engine.params
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        with uncounted():
            toks = torch.from_numpy(np.resize(prompts[1], INVARIANT_L + 1)).to(
                device)[None].long()
            cell["decode_matches_forward"] = check_decode_vs_forward(
                torch, lm, cfg, eparams, toks,
                bf16_ungated=BF16_UNGATED.get(arch))
            cell["scalar_vs_per_slot"] = scalar_vs_per_slot(
                torch, lm, cfg, eparams, toks[:, :INVARIANT_L])
            sites = attention_sites(cfg)
            if sites:
                real.update(real_layer_checks(
                    torch, lm, cfg, eparams,
                    torch.from_numpy(np.resize(prompts[2], REAL_PROMPT)).to(device)[None],
                    calls={0: "shared site 0", sites - 1: f"shared site {sites - 1}"}))
        del eparams
        gc.collect()
        torch.cuda.empty_cache()
        cell["seconds"] = time.perf_counter() - t1
        emit({"phase": "ssm", "arch": arch, **cell})
        out[arch] = cell
    out["real_layer_checks"] = real
    out["seconds"] = time.perf_counter() - t0
    emit({k: v for k, v in out.items() if k not in SSM_ARCHS})
    return max(c["max_abs_err"] for c in real.values()), out


def phase_whisper(torch, device):
    """whisper-base at full width and depth (random params and frames from a
    seed): the engine's refusal by name; then lm.encode of WHISPER_BATCH ×
    1,500 frames, lm.prefill (its own encode, the cross K/V fill, the
    WHISPER_PROMPT-token decoder prompt) and WHISPER_DECODES greedy
    lm.decode_step calls at a scalar position, with the launch counts set to
    0 just before the encode and gated exactly after each part: encode one
    flash launch per encoder layer (non-causal, 1,500 × 1,500), prefill
    that again plus one self and one cross launch per decoder layer, a step
    one self and one cross launch per decoder layer. Then decode against
    forward and the kernel on the real q, k and v of the encoder's first
    layer and the first decoder layer's self and cross attention. Returns
    (the real layers' worst error, the phase's numbers)."""
    import gc

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServeEngine

    t0 = time.perf_counter()
    cfg = get_config("whisper-base")
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    params = lm.init_params(cfg, gen, device)
    out = {"phase": "whisper", "arch": cfg.name,
           "params": sum(x.numel() for x in lm.tree_leaves(params))}
    try:
        ServeEngine(cfg, params, slots=SERVE_SLOTS, max_seq=WHISPER_MAX_SEQ,
                    device=device)
    except NotImplementedError as e:
        out["engine_refuses"] = str(e)
    else:
        raise AssertionError("ServeEngine accepted an encoder-decoder model")
    eparams = lm.compute_params(cfg, params)
    del params
    frames = torch.randn((WHISPER_BATCH, cfg.encoder_len, cfg.d_model),
                         generator=gen, device=device)
    rng = np.random.default_rng(LM_SEED + 4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        WHISPER_BATCH, WHISPER_PROMPT + 1))).to(device)
    batch = {"tokens": toks[:, :WHISPER_PROMPT], "frames": frames}
    with uncounted():  # warm cuBLAS and the kernel's library
        logits, caches = lm.prefill(cfg, eparams, batch, WHISPER_MAX_SEQ)
        lm.decode_step(cfg, eparams, caches,
                       logits[:, -1].argmax(-1).to(torch.int32)[:, None],
                       WHISPER_PROMPT)
        del logits, caches
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    enc_layers = sum(len(b) * rep for b, rep in cfg.encoder_segments)
    dec_layers = cfg.num_layers
    want = {"encode": enc_layers, "prefill": enc_layers + 2 * dec_layers,
            "decode step": 2 * dec_layers}
    launches = {}
    reset_counts()
    t1 = time.perf_counter()
    lm.encode(cfg, eparams, frames)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches["encode"] = read_counts()["flash"]
    logits, caches = lm.prefill(cfg, eparams, batch, WHISPER_MAX_SEQ)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches["prefill"] = read_counts()["flash"] - launches["encode"]
    generated = [tok]
    for step in range(WHISPER_DECODES):
        lg, caches = lm.decode_step(cfg, eparams, caches, tok,
                                    WHISPER_PROMPT + step)
        tok = lg.argmax(-1).to(torch.int32)[:, None]
        generated.append(tok)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    counts = read_counts()
    launches["decode step"] = (counts["flash"] - launches["encode"]
                               - launches["prefill"]) / WHISPER_DECODES
    if launches != want or counts["megastep"] or counts["raster"]:
        raise AssertionError(f"whisper-base: flash launches {launches}, want "
                             f"{want}; all counts {counts}")
    generated = torch.cat(generated, dim=1)
    if not (bool(torch.isfinite(lg).all()) and bool(
            ((generated >= 0) & (generated < cfg.vocab_size)).all())):
        raise AssertionError("whisper-base: non-finite logits or tokens out "
                             "of the vocabulary")
    out["run"] = {
        "batch": WHISPER_BATCH, "frames": cfg.encoder_len,
        "prompt": WHISPER_PROMPT, "max_seq": WHISPER_MAX_SEQ,
        "decode_steps": WHISPER_DECODES, "encode_s": t2 - t1,
        "prefill_s": t3 - t2, "decode_step_ms": 1e3 * (t4 - t3) / WHISPER_DECODES,
        "decode_tokens_per_s": WHISPER_BATCH * WHISPER_DECODES / (t4 - t3),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "launches_total": counts["flash"],
        "clock": "host clock; encode, prefill and the decode steps each end "
                 "in a synchronize"}
    del logits, lg, caches
    gc.collect()
    torch.cuda.empty_cache()

    with uncounted():
        out["decode_matches_forward"] = check_decode_vs_forward(
            torch, lm, cfg, eparams, toks[:1].long(), frames=frames[:1])
        real = real_layer_checks(
            torch, lm, cfg, eparams, batch["tokens"], frames=frames,
            max_seq=WHISPER_MAX_SEQ,
            calls={0: "encoder layer 0", enc_layers: "decoder layer 0 self",
                   enc_layers + 1: "decoder layer 0 cross",
                   enc_layers + 2 * dec_layers - 1:
                       f"decoder layer {dec_layers - 1} cross"})
    out["real_layer_checks"] = real
    del eparams, frames
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return max(c["max_abs_err"] for c in real.values()), out


# -- LM training -----------------------------------------------------------------
#: h2o-danube-1.8b at full width and depth (24 layers, 1.83 B params) through
#: launch/train.py's loop: TRAIN_BATCH × TRAIN_SEQ tokens a step, remat
#: "dots", TRAIN_WARMUP steps then TRAIN_TIMED timed ones
TRAIN_ARCH, TRAIN_REMAT = "h2o-danube-1.8b", "dots"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_TIMED = 4, 2048, 2, 10
#: flash launches a layer a step: the attention forward, and the same again
#: when "dots" recomputes the layer in the backward (it keeps the products'
#: outputs, not the kernel's); the Function's backward launches none
TRAIN_FLASH_PER_LAYER = 2
#: the kernel-forward check: danube at full width, TRAIN_CHECK_LAYERS of
#: its 24 layers, one step's gradients through the kernel against the same
#: with attention on the plain backend (both take the plain backward):
#: ||kernel - plain|| over every gradient leaf at most TRAIN_GRAD_REL of
#: ||plain|| (bf16: the JAX package's bf16 attention tolerance; f32: the
#: f32 decode-against-forward tolerance)
TRAIN_CHECK_LAYERS = 2
TRAIN_GRAD_REL = {"bfloat16": 5e-2, "float32": F32_LOGIT_TOL}
#: the remat policies on the card, through the kernel at those 2 layers in
#: bf16: "dots" and "full" against "none", the loss and the gradients within
#: REMAT_REL of their norm (the recomputed forward runs the same kernels on
#: the same inputs; the bound leaves room for sums in atomic order), and
#: each launching the kernel again in its recompute
REMAT_CHECK, REMAT_REL = ("none", "dots", "full"), 1e-6
#: every arch's reduced config, ARCH_STEPS train steps on the card against
#: the same steps on the CPU (f32 both, the same params and batches): each
#: step's loss and grad_norm, and the params after, within ARCH_REL
#: (relative; the params' over their norm). The two devices order their f32
#: sums otherwise, as the port and JAX do: 1e-4 is the reduced xLSTM's
#: noise against JAX (tests/test_torch_ssm_grads.py)
ARCH_STEPS, ARCH_BATCH, ARCH_SEQ, ARCH_REL = 2, 2, 32, 1e-4


def tree_rel_err(torch, got, want):
    """(||got - want|| / ||want|| over every leaf of two trees, the worst
    leaf's own)."""
    from repro_torch.models import lm

    num = den = 0.0
    worst = 0.0
    for a, b in zip(lm.tree_leaves(got), lm.tree_leaves(want)):
        d = float((a.float() - b.float()).norm()) ** 2
        n = float(b.float().norm()) ** 2
        num, den = num + d, den + n
        worst = max(worst, math.sqrt(d / n) if n else math.sqrt(d))
    return math.sqrt(num / den), worst


def train_on_both(torch, device, arch, tc):
    """ARCH_STEPS steps of `arch`'s reduced config from the same params on
    the CPU and on the card; the card's flash launches; raises past
    ARCH_REL, or where zero-padded heads launched no flash kernel. Head
    dims the kernel has no instantiation for (the reduced MiniCPM3's
    MLA heads, (24, 16)) reach it zero-padded (ops.padded_pair)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.kernels.attention import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import lm
    from repro_torch.train import trainer

    cfg = get_config(arch, reduced=True)
    heads = ((cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim)
             if cfg.kv_lora_rank else (cfg.hd, cfg.hd))
    pad = ops.padded_pair(*heads)
    params = lm.init_params(cfg, torch.Generator().manual_seed(LM_SEED), "cpu")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=ARCH_SEQ,
                    global_batch=ARCH_BATCH)
    batches = [launch_train.batch_at(cfg, dc, s, "cpu") for s in range(ARCH_STEPS)]
    runs = {}
    for dev in (torch.device("cpu"), device):
        p = lm.tree_map(lambda x: x.to(dev, copy=True), params)
        opt = trainer.make_optimizer(tc).init(p)
        step = trainer.make_train_step(cfg, tc)
        metrics = []
        before = read_counts()["flash"]
        for batch in batches:
            p, opt, m = step(p, opt, {k: v.to(dev) for k, v in batch.items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[dev.type] = (metrics, p, read_counts()["flash"] - before)
    (cpu_m, cpu_p, _), (card_m, card_p, flash) = runs["cpu"], runs["cuda"]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    out = {"losses": [m[0] for m in card_m], "cpu_losses": [m[0] for m in cpu_m],
           "loss_rel_err": max(rel(a[0], b[0]) for a, b in zip(card_m, cpu_m)),
           "grad_norm_rel_err": max(rel(a[1], b[1]) for a, b in zip(card_m, cpu_m)),
           "params_rel_err": tree_rel_err(torch, lm.tree_map(lambda x: x.cpu(), card_p),
                                          cpu_p)[0],
           "flash_launches": flash, "attention": f"flash kernel, {heads} "
           f"zero-padded to {pad}" if pad else "flash kernel",
           "tol": ARCH_REL}
    if not all(math.isfinite(m[0]) for m in card_m) or max(
            out["loss_rel_err"], out["grad_norm_rel_err"],
            out["params_rel_err"]) > ARCH_REL or (pad and not flash):
        raise AssertionError(f"{arch} train steps, card against CPU: {out}")
    return out


def attention_backward_check(torch, device, bw, fp32_flops, bf16_flops):
    """The attention Function (kernel forward, the JAX package's plain
    backward) at h2o-danube-1.8b's training shape: its gradients against
    autograd through attention_ref on the card, in bf16 and f32 (within the
    JAX package's attention tolerance, relative to each gradient's norm);
    in bf16 the backward's time beside the kernel's forward, SDPA's forward
    and SDPA's backward, and the backward's bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.attention import attention_ref, flash_attention_cuda, ops

    hq, hkv, d, dv = DANUBE_HEADS
    b, l, window = TRAIN_BATCH, TRAIN_SEQ, 4096
    kw = dict(causal=True, window=window)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        q, k, v = (x.requires_grad_() for x in attention_inputs(
            torch, DANUBE_HEADS, b, l, l, dtype, 99, device))
        g = torch.Generator(device=device).manual_seed(100)
        do = torch.randn((b, hq, l, dv), generator=g, device=device).to(dtype)
        with uncounted():
            o = ops.attention(q, k, v, **kw)
            got = torch.autograd.grad(o, (q, k, v), do, retain_graph=True)
            want = torch.autograd.grad(attention_ref(q, k, v, **kw), (q, k, v), do)
            errs = {f"d{n}": float((a.float() - w.float()).norm() / w.float().norm())
                    for n, a, w in zip("qkv", got, want)}
            case = {"dtype": name, "heads": DANUBE_HEADS, "B": b, "L": l,
                    "window": window, "rel_err": errs, "tol": ATTN_TOL[name],
                    "grad_dtypes": sorted({str(x.dtype) for x in got})}
            if max(errs.values()) > ATTN_TOL[name] or case["grad_dtypes"] != [str(dtype)]:
                raise AssertionError(f"attention backward {name}: {case}")
            del want
            if dtype == torch.bfloat16:
                pairs, _, fwd_flops = attention_work(b, DANUBE_HEADS, l, l, True,
                                                     window, 0, 2)
                # recompute S (2D), dP (2Dv), dV (2Dv), dQ (2D), dK (2D) a pair;
                # q, k, v, dO read once, dQ, dK, dV written once
                flops = pairs * (6 * d + 4 * dv)
                moved = 2 * b * (hq * l * (2 * d + dv) + hkv * l * 2 * (d + dv))
                bound_ms, bound_by = bound(moved, flops, bw, bf16_flops)
                qd, kd, vd = (x.detach() for x in (q, k, v))
                sdpa_o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                        enable_gqa=True)
                case.update(
                    live_pairs=pairs, backward_flops=flops, backward_bytes=moved,
                    backward_bound_ms=bound_ms, backward_bound_by=bound_by,
                    backward_ms=event_ms(torch, lambda: torch.autograd.grad(
                        o, (q, k, v), do, retain_graph=True), 5, warmup=1),
                    kernel_forward_ms=event_ms(torch, lambda: flash_attention_cuda(
                        qd, kd, vd, **kw), 20),
                    sdpa_forward_ms=event_ms(torch, lambda: F.scaled_dot_product_attention(
                        qd, kd, vd, is_causal=True, enable_gqa=True), 20),
                    sdpa_backward_ms=event_ms(torch, lambda: torch.autograd.grad(
                        sdpa_o, (q, k, v), do, retain_graph=True), 20),
                    forward_flops=fwd_flops,
                    clock="CUDA events: backward over 5 calls, the rest over 20")
                del sdpa_o
        out[name] = case
        del q, k, v, do, o, got
        torch.cuda.empty_cache()
    return out


def phase_lm_train(torch, device, bw, fp32_flops, bf16_flops):
    """LM training: h2o-danube-1.8b at full width and depth through the
    port's launcher loop (launch/train.py: the main path of this phase),
    counts set to 0 just before and read just after (TRAIN_FLASH_PER_LAYER
    flash launches a layer a step); ms a step, tokens/s, peak memory, the
    losses and grad norms; one more step under the profiler. Then the
    kernel forward against the plain forward at 2 layers, every reduced
    arch's train steps on the card against the CPU (accum_steps=2 and
    compress_pod_grads once each), and the attention backward alone."""
    import dataclasses
    import gc

    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.models import lm
    from repro_torch.train import trainer

    t0 = time.perf_counter()
    out = {"phase": "lm_train"}
    steps = TRAIN_WARMUP + TRAIN_TIMED
    cfg = get_config(TRAIN_ARCH)
    argv = ["--arch", TRAIN_ARCH, "--no-reduced", "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--remat", TRAIN_REMAT, "--steps",
            str(steps), "--log-every", "1"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run = launch_train.main(argv)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"megastep": 0, "raster": 0,
            "flash": steps * TRAIN_FLASH_PER_LAYER * cfg.num_layers}
    if launches != want:
        raise AssertionError(f"lm_train: launches {launches}, want {want}")
    hist = run["history"]
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses) or not (
            statistics.mean(losses[-3:]) < losses[0]):
        raise AssertionError(f"lm_train: losses {losses} (finite, the mean of "
                             f"the last 3 below the first)")
    timed_s = [h["seconds"] for h in hist[TRAIN_WARMUP:]]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out["run"] = {
        "argv": argv, "params": sum(x.numel() for x in lm.tree_leaves(run["params"])),
        "layers": cfg.num_layers, "steps": steps, "timed_steps": TRAIN_TIMED,
        "tokens_per_step": tokens,
        "ms_per_step_median": 1e3 * statistics.median(timed_s),
        "ms_per_step": [1e3 * x for x in timed_s],
        "tokens_per_s": tokens * len(timed_s) / sum(timed_s),
        "peak_gb": peak / 1e9, "losses": losses,
        "grad_norms": [h["grad_norm"] for h in hist], "lrs": [h["lr"] for h in hist],
        "launches": launches, "flash_per_step": launches["flash"] / steps,
        "clock": "host clock around each step, ended by reading its loss"}
    emit({"phase": "lm_train_run", **out["run"]})

    # one more step of the same run under the profiler
    params, opt, step_fn = run["params"], run["opt"], run["step_fn"]
    batch = launch_train.batch_at(cfg, run["dc"], steps, device)
    del run
    with uncounted():
        prof = profile_window(torch, lambda: step_fn(params, opt, batch), 1,
                              ranges=trainer.STAGES + ("attention::backward",))
    busy = prof["device_busy_ms"]
    prof["device_share"] = ({n: r["device_ms"] / busy
                             for n, r in prof["ranges_ms"].items()}
                            if busy else None)
    out["profiled_step"] = prof
    del params, opt, step_fn, batch
    gc.collect()
    torch.cuda.empty_cache()

    # the kernel forward against the plain forward, 2 layers at full width
    checks = {}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, segments=((("swa",), TRAIN_CHECK_LAYERS),),
                                dtype=dtype)
        p = lm.init_params(c, torch.Generator(device=device).manual_seed(LM_SEED),
                           device)
        dc = DataConfig(vocab_size=c.vocab_size, seq_len=TRAIN_SEQ,
                        global_batch=TRAIN_BATCH)
        batch = launch_train.batch_at(c, dc, 0, device)
        remats = {}
        with uncounted():
            for remat in REMAT_CHECK if dtype == "bfloat16" else ("none",):
                before = read_counts()["flash"]
                remats[remat] = trainer.loss_and_grads(c, p, batch, remat) + (
                    read_counts()["flash"] - before,)
            with captured_attention(set(), "torch"):
                loss_p, grads_p = trainer.loss_and_grads(c, p, batch, "none")
        loss_k, grads_k, kernel_launches = remats.pop("none")
        rel, worst = tree_rel_err(torch, grads_k, grads_p)
        checks[dtype] = {"layers": TRAIN_CHECK_LAYERS, "loss_kernel": float(loss_k),
                         "loss_plain": float(loss_p), "grad_rel_err": rel,
                         "worst_leaf_rel_err": worst, "tol": TRAIN_GRAD_REL[dtype],
                         "kernel_launches": kernel_launches}
        if kernel_launches != TRAIN_CHECK_LAYERS or rel > TRAIN_GRAD_REL[dtype]:
            raise AssertionError(f"lm_train kernel against plain forward, "
                                 f"{dtype}: {checks[dtype]}")
        # the remat policies against "none", through the kernel
        for remat, (loss_r, grads_r, launches_r) in remats.items():
            checks[dtype][f"remat_{remat}"] = {
                "loss": float(loss_r), "grad_rel_err": tree_rel_err(
                    torch, grads_r, grads_k)[0], "kernel_launches": launches_r,
                "tol": REMAT_REL}
            if (launches_r != TRAIN_FLASH_PER_LAYER * TRAIN_CHECK_LAYERS
                    or checks[dtype][f"remat_{remat}"]["grad_rel_err"] > REMAT_REL
                    or abs(float(loss_r) - float(loss_k)) > REMAT_REL * abs(float(loss_k))):
                raise AssertionError(f"lm_train remat {remat!r} against 'none': "
                                     f"{checks[dtype]}")
        del p, grads_k, grads_p, batch, remats
        gc.collect()
        torch.cuda.empty_cache()
    out["kernel_vs_plain_forward"] = checks

    # every reduced arch on the card against the CPU
    tc = trainer.TrainConfig(lr=1e-3, warmup=1, total_steps=10)
    with uncounted():
        archs = {arch: train_on_both(torch, device, arch, tc) for arch in ARCH_IDS}
        archs[f"{TRAIN_ARCH} accum_steps=2"] = train_on_both(
            torch, device, TRAIN_ARCH, dataclasses.replace(tc, accum_steps=2))
        archs[f"{TRAIN_ARCH} compress_pod_grads"] = train_on_both(
            torch, device, TRAIN_ARCH,
            dataclasses.replace(tc, compress_pod_grads=True))
    out["reduced_archs_card_vs_cpu"] = archs

    out["attention_backward"] = attention_backward_check(torch, device, bw,
                                                         fp32_flops, bf16_flops)
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def phase_ssm_profile(torch, device):
    """Where a recurrent prefill's time goes, not run by main(): profiler
    windows over one prefill of zamba2-2.7B and of xLSTM-350M at 2,048
    tokens (GLA chunk 256) and at PRIME_PROMPT (chunk 1). A window of ~0.2 M
    launches takes minutes of the profiler's own processing."""
    import gc

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm

    t0, out = time.perf_counter(), {}
    for arch in SSM_ARCHS:
        cfg = get_config(arch)
        params = lm.compute_params(cfg, lm.init_params(
            cfg, torch.Generator(device=device).manual_seed(LM_SEED), device))
        gc.collect()
        prompt = lm_prompts(cfg.vocab_size)[2]
        with uncounted():
            for n in (REAL_PROMPT, PRIME_PROMPT):
                toks = torch.from_numpy(np.resize(prompt, n)).to(device)[None]
                out[f"{arch}_prefill_{n}"] = profile_window(
                    torch, lambda: lm.prefill(cfg, params, {"tokens": toks},
                                              SERVE_MAX_SEQ), 1)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "ssm_profile", "seconds": time.perf_counter() - t0, **out})
    return out


def phase_lm_profile(torch, device):
    """Where the serving runs' time goes: on a fresh Yi-6B engine, a
    profiler window over decode ticks (every slot decodes whether active or
    not, so the zeroed caches cost what full ones do) and over one
    2,048-token prefill; the same on a fresh OLMoE-1B-7B engine;
    MiniCPM3-4B's decode steps after phase mla's 4 × 2,048-token prefill;
    on fresh zamba2-2.7B and xLSTM-350M engines their ticks; Whisper's
    decode steps after phase whisper's prefill.
    Last of the phases: a profiler leaves the CUDA launches of the process
    slower after it stops."""
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

    cfg = get_config("olmoe-1b-7b")
    engine = ServeEngine(cfg, lm.init_params(
        cfg, torch.Generator(device=device).manual_seed(LM_SEED), device),
        slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, device=device)
    gc.collect()
    toks = torch.from_numpy(np.resize(lm_prompts(cfg.vocab_size)[2],
                                      REAL_PROMPT)).to(device)[None]
    with uncounted():
        out["olmoe_decode_tick"] = profile_window(
            torch, lambda: engine._decode(engine.params, engine.state),
            PROFILE_TICKS)
        out["olmoe_prefill_2048"] = profile_window(torch, lambda: lm.prefill(
            cfg, engine.params, {"tokens": toks}, SERVE_MAX_SEQ), 1)
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config("minicpm3-4b")
    params = lm.compute_params(cfg, lm.init_params(
        cfg, torch.Generator(device=device).manual_seed(LM_SEED), device))
    gc.collect()
    torch.cuda.empty_cache()
    toks = torch.from_numpy(np.random.default_rng(LM_SEED + 2).integers(
        0, cfg.vocab_size, (MLA_BATCH, MLA_PROMPT))).to(device)
    with uncounted():
        logits, caches = lm.prefill(cfg, params, {"tokens": toks}, SERVE_MAX_SEQ)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        out["minicpm3_decode_step"] = profile_window(
            torch, lambda: lm.decode_step(cfg, params, caches, tok, MLA_PROMPT),
            PROFILE_TICKS)
    del params, caches, logits
    gc.collect()
    torch.cuda.empty_cache()

    # the recurrent models' ticks (their prefills: phase_ssm_profile)
    for arch in SSM_ARCHS:
        cfg = get_config(arch)
        engine = ServeEngine(cfg, lm.init_params(
            cfg, torch.Generator(device=device).manual_seed(LM_SEED), device),
            slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, device=device)
        gc.collect()
        with uncounted():
            out[f"{arch}_decode_tick"] = profile_window(
                torch, lambda: engine._decode(engine.params, engine.state),
                PROFILE_TICKS)
        del engine
        gc.collect()
        torch.cuda.empty_cache()

    cfg = get_config("whisper-base")
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    params = lm.compute_params(cfg, lm.init_params(cfg, gen, device))
    frames = torch.randn((WHISPER_BATCH, cfg.encoder_len, cfg.d_model),
                         generator=gen, device=device)
    toks = torch.from_numpy(np.random.default_rng(LM_SEED + 4).integers(
        0, cfg.vocab_size, (WHISPER_BATCH, WHISPER_PROMPT))).to(device)
    with uncounted():
        logits, caches = lm.prefill(cfg, params, {"tokens": toks, "frames": frames},
                                    WHISPER_MAX_SEQ)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        out["whisper_decode_step"] = profile_window(
            torch, lambda: lm.decode_step(cfg, params, caches, tok,
                                          WHISPER_PROMPT), PROFILE_TICKS)
    del params, caches, logits, frames
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
    flash_err, timed_flash = phase_attention(torch, device, bw, flops,
                                             bf16_flops)
    flash = timed_flash["lm"]
    lm_err, lm_out = phase_lm(torch, device)
    mla_err, mla_out = phase_mla(torch, device)
    absorbed_err, absorbed_out = phase_absorbed(
        torch, device, bw, flops, bf16_flops, mla_out["run"]["decode_step_ms"])
    moe_err, moe_out = phase_moe(torch, device)
    ssm_err, ssm_out = phase_ssm(torch, device)
    whisper_err, whisper_out = phase_whisper(torch, device)
    train_out = phase_lm_train(torch, device, bw, flops, bf16_flops)
    flash_err = max(flash_err, lm_err, mla_err, absorbed_err, moe_err, ssm_err,
                    whisper_err)
    flash_paths = {"lm": lm_out["serve"]["launches"]["flash"],
                   "mla": mla_out["run"]["launches"]["flash"],
                   "absorbed": absorbed_out["run"]["launches"]["flash"],
                   "moe": moe_out["serve"]["launches"]["flash"],
                   "ssm": sum(ssm_out[a]["serve"]["launches"]["flash"]
                              for a in SSM_ARCHS),
                   "whisper": whisper_out["run"]["launches_total"],
                   "train": train_out["run"]["launches"]["flash"]}
    mega_err = phase_kernel(torch, device)
    raster_err, grid_raster = phase_raster(torch, device, bw, flops)
    pools, vmap_pools, render_pools, launches = phase_main(torch, device, sync)
    errs = phase_render_check(torch, device, render_pools)
    mega_err, raster_err = max(mega_err, errs[0]), max(raster_err, errs[1])
    del render_pools
    phase_parity(torch, device)
    phase_golden(device)
    compat_launches = phase_compat(torch, device, smi)
    train_launches, train_err, eager = phase_train(torch, device)
    mega_err = max(mega_err, train_err)
    fused_launches = phase_fused(torch, device, eager)
    ppo_launches = phase_ppo(torch, device)
    async_launches, async_err = phase_async(torch, device)
    mega_err = max(mega_err, async_err)
    runtime_launches = phase_runtime(torch, device)
    phase_audit(torch, device)
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
    phase_train_profile(torch, eager)
    phase_lm_profile(torch, device)

    cartpole = bodies["CartPole"]
    pong = pixel["Pong-v0"]
    heads_row = lambda case: {k: case[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library",
        "max_abs_err", "case", "dtype", "heads", "B", "Lq", "Lk", "causal",
        "live_pairs", "bytes", "flops")}
    emit({"kernels": [{
        "name": "megastep",
        "route": "cuda",
        "source": "src/repro_torch/csrc/megastep.cu",
        "replaces": "src/repro/kernels/envstep/megastep.py:80",
        "launches": (launches["megastep"] + train_launches["megastep"]
                     + compat_launches["megastep"]
                     + fused_launches["megastep"] + ppo_launches
                     + async_launches["megastep"]
                     + runtime_launches["megastep"]),
        "launches_per_path": {"env": launches["megastep"],
                              "train": train_launches["megastep"],
                              "compat": compat_launches["megastep"],
                              "fused": fused_launches["megastep"],
                              "ppo": ppo_launches,
                              "async": async_launches["megastep"],
                              "runtime": runtime_launches["megastep"]},
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
        "launches": (launches["raster"] + train_launches["raster"]
                     + compat_launches["raster"] + fused_launches["raster"]
                     + async_launches["raster"]
                     + runtime_launches["raster"]),
        "launches_per_path": {"env": launches["raster"],
                              "train": train_launches["raster"],
                              "compat": compat_launches["raster"],
                              "fused": fused_launches["raster"],
                              "async": async_launches["raster"],
                              "runtime": runtime_launches["raster"]},
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
        "launches": sum(flash_paths.values()),
        "launches_per_path": flash_paths,
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
        "minicpm3_heads": heads_row(timed_flash["mla"]),
        "absorbed_heads": heads_row(absorbed_out["timed"]["absorbed"]),
        "absorbed_decode": heads_row(absorbed_out["timed"]["absorbed_decode"]),
        "absorbed_max_abs_err": absorbed_err,
        "whisper_heads": heads_row(timed_flash["whisper"]),
        "danube_train_heads": heads_row(timed_flash["train"]),
        "card": smi,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
