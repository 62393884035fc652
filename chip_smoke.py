#!/usr/bin/env python3
"""Build and run the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

from the repository root, on a machine with a CUDA card and the CUDA
toolkit. It exits non-zero, printing no result, when there is no card or no
repository around it. Phases, each printing one JSON line:

  device   the card (and nvidia-smi's name and power limit line)
  build    nvcc build of csrc/megastep.cu, with ptxas's register report
  kernel   the CUDA megastep against its plain PyTorch version on the card,
           four env bodies with and without a TimeLimit, at B = 65,573
           (a ragged last block) and K = 32
  main     make_vec(id, 65536, unroll=32).rollout(1024) for the four
           classic-control ids through the kernel (launch counts), then the
           same rollout again with host syncs made errors
  parity   64-step rollouts, backend "cuda" against "torch", on the card
  golden   the committed tests/golden traces, replayed on the card
  numbers  env steps/s per id at B = 65,536, CartPole-v1 also at B = 4,096
  split    the kernel against its plain version on a CartPole-v1 chunk at
           the main path's shapes, then per-chunk times of the kernel, the
           fresh-reset precompute and the action sampling
then the kernels line, and last `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

IDS = ("CartPole-v1", "MountainCar-v0", "Pendulum-v1", "Acrobot-v1")
GOLDEN_IDS = IDS + ("CartPole-raw", "MountainCar-raw", "Pendulum-raw",
                    "Acrobot-raw")
B_MAIN, B_SMALL, B_CHECK = 65536, 4096, 65536 + 37
K, STEPS, PARITY_STEPS = 32, 1024, 64
RTOL, ATOL = 1e-5, 1e-6           # tests/conftest.py::assert_leaves_match
GOLDEN_TOL = 1e-4                 # tests/test_golden.py
TIMED_RUNS = 3

#: (name fragment, memory bytes/s, fp32 non-tensor FLOP/s), NVIDIA data
#: sheets; the first fragment found in the card's name applies
CARDS = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
         ("H100", 3.35e12, 67e12), ("H200", 4.8e12, 67e12))

#: float ops per lane-step of the CartPole body with TimeLimit, counted in
#: csrc/megastep.cu: each add, multiply, divide, compare, select, fabsf,
#: sinf and cosf is one, the TimeLimit fold and the reset selects included
CARTPOLE_OPS_PER_LANE_STEP = 49

#: uniform ranges of the state rows fed to the kernel check, wide enough
#: that episodes end, velocities clamp and angles wrap inside K steps
STATE_RANGES = {
    "CartPole": [(-2.4, 2.4), (-2.0, 2.0), (-0.21, 0.21), (-2.0, 2.0)],
    "MountainCar": [(-1.2, 0.6), (-0.07, 0.07)],
    "Pendulum": [(-3 * math.pi, 3 * math.pi), (-8.0, 8.0)],
    "Acrobot": [(-math.pi, math.pi), (-math.pi, math.pi),
                (-4 * math.pi, 4 * math.pi), (-9 * math.pi, 9 * math.pi)],
}
MAX_STEPS = {"CartPole": 500, "MountainCar": 200, "Pendulum": 200,
             "Acrobot": 500}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_rates(name: str):
    for fragment, bw, flops in CARDS:
        if fragment in name:
            return bw, flops
    raise RuntimeError(f"no data-sheet rates for {name!r}")


def megastep_bytes(b: int, k: int, s: int, o: int) -> int:
    """Bytes one megastep must move: each input read once, each output
    written once. s counts the TimeLimit row when there is one."""
    reads = s + k * (1 + s + o)           # state; act, fresh, fresh_obs
    writes = s + k * (2 * o + 3)          # state; obs, tobs, rew, done, trunc
    return 4 * b * (reads + writes)


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


# -- phases --------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name, smi


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build(["megastep"])
    build.load("megastep")
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs), "ptxas": ptxas})


def kernel_inputs(torch, name, time_limit, b, k, seed, device):
    """numpy-seeded megastep operands for one env body."""
    import numpy as np

    from repro_torch.kernels.envstep import BODIES

    body = BODIES[name]
    rng = np.random.default_rng(seed)
    ranges = STATE_RANGES[name]

    def states(lead):
        rows = [rng.uniform(lo, hi, lead + (b,)) for lo, hi in ranges]
        if time_limit:
            rows.append(rng.integers(0, MAX_STEPS[name], lead + (b,)))
        return np.stack(rows, -2)

    if name == "Pendulum":
        act = rng.uniform(-3.0, 3.0, (k, b))
    else:
        act = rng.integers(0, 3 if name != "CartPole" else 2, (k, b))
    fresh = states((k,))
    if time_limit:
        fresh[:, -1] = 0
    ops = (states(()), act, fresh,
           rng.standard_normal((k, body.obs_size, b)))
    return [torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()
            for x in ops]


def compare(torch, got, want, what):
    """done and truncated exact, floats within RTOL/ATOL; max abs error."""
    names = ("new_state", "obs", "terminal_obs", "reward", "done", "truncated")
    err = 0.0
    for n, g, w in zip(names, got, want):
        if n in ("done", "truncated"):
            if not torch.equal(g, w):
                raise AssertionError(f"{what}: {n} differs in "
                                     f"{int((g != w).sum())} places")
            continue
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL,
                                   msg=lambda m: f"{what}: {n}: {m}")
        err = max(err, float((g - w).abs().max()))
    return err


def phase_kernel(torch, device):
    from repro_torch.kernels.envstep import BODIES, megastep_cuda, megastep_ref
    from repro_torch.kernels.envstep.specs import spec_for
    from repro_torch.envs.classic import Acrobot, CartPole, MountainCar, Pendulum

    envs = {"CartPole": CartPole(), "MountainCar": MountainCar(),
            "Pendulum": Pendulum(), "Acrobot": Acrobot()}
    rows, worst = [], 0.0
    for i, (name, env) in enumerate(envs.items()):
        spec = spec_for(env)
        for time_limit in (True, False):
            max_steps = MAX_STEPS[name] if time_limit else None
            ops = kernel_inputs(torch, name, time_limit, B_CHECK, K, i, device)
            got = megastep_cuda(BODIES[name].kernel_id, *ops,
                                max_steps=max_steps)
            want = megastep_ref(spec.step_rows, *ops, max_steps=max_steps)
            err = compare(torch, got, want, f"{name} max_steps={max_steps}")
            worst = max(worst, err)
            rows.append({"body": name, "max_steps": max_steps,
                         "max_abs_err": err,
                         "dones": int(got[4].sum()),
                         "truncations": int(got[5].sum())})
    emit({"phase": "kernel", "B": B_CHECK, "K": K, "rtol": RTOL, "atol": ATOL,
          "cases": rows})
    return worst


def phase_main(torch, device, sync):
    import repro_torch
    from repro_torch import random as R
    from repro_torch.kernels.envstep import megastep_cuda

    pools, rows = {}, []
    key = R.PRNGKey(0, device)
    megastep_cuda.launches = 0
    for env_id in IDS:
        pool = repro_torch.make_vec(env_id, B_MAIN, unroll=K, device=device)
        pool.reset(0)
        before = megastep_cuda.launches
        t0 = time.perf_counter()
        rew, eps, _ = pool.rollout(STEPS, key)
        sync()
        seconds = time.perf_counter() - t0
        launches = megastep_cuda.launches - before
        if launches != STEPS // K:
            raise AssertionError(f"{env_id}: {launches} megastep launches in "
                                 f"a {STEPS}-step rollout, want {STEPS // K}")
        check_rollout(torch, env_id, rew, eps)
        pools[env_id] = pool
        rows.append({"id": env_id, "backend": pool.backend,
                     "launches": launches, "first_rollout_s": seconds,
                     "episodes": int(eps.sum()),
                     "mean_return_per_step": float(rew.sum()) / (B_MAIN * STEPS)})
    main_launches = megastep_cuda.launches

    # Steady state with every host sync an error: the port's counterpart of
    # the JAX package's zero-host-transfer check on the compiled rollout.
    for env_id, pool in pools.items():
        if device.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = pool.rollout(STEPS, key)
        finally:
            if device.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        check_rollout(torch, env_id, out[0], out[1])
    emit({"phase": "main", "B": B_MAIN, "K": K, "steps": STEPS, "rows": rows,
          "megastep_launches": main_launches, "sync_free_steady_state": True})
    return pools, main_launches


def check_rollout(torch, env_id, rew, eps):
    if rew.shape != (B_MAIN,) or eps.shape != (B_MAIN,):
        raise AssertionError(f"{env_id}: rollout shapes {rew.shape}, {eps.shape}")
    if not bool(torch.isfinite(rew).all()) or int(eps.min()) < 0:
        raise AssertionError(f"{env_id}: non-finite returns or negative "
                             "episode counts")


def phase_parity(torch, device):
    import repro_torch
    from repro_torch import random as R

    rows = []
    key = R.PRNGKey(1, device)
    for env_id in IDS:
        out = {}
        for backend in ("cuda", "torch"):
            pool = repro_torch.make_vec(env_id, B_MAIN, backend=backend,
                                        unroll=K, device=device)
            out[backend] = pool.rollout(PARITY_STEPS, key)
        rew_c, eps_c, _ = out["cuda"]
        rew_t, eps_t, _ = out["torch"]
        if not torch.equal(eps_c, eps_t):
            raise AssertionError(f"{env_id}: episode counts differ in "
                                 f"{int((eps_c != eps_t).sum())} lanes")
        torch.testing.assert_close(rew_c, rew_t, rtol=RTOL, atol=ATOL)
        rows.append({"id": env_id, "episodes": int(eps_c.sum()),
                     "max_abs_err_sum_reward": float((rew_c - rew_t).abs().max())})
    emit({"phase": "parity", "B": B_MAIN, "steps": PARITY_STEPS, "rows": rows})


def phase_golden(device, backend):
    """The tests/test_envspec.py::_pool_trace recipe through the port."""
    import numpy as np

    import repro_torch
    from repro_torch import random as R
    from repro_torch.core.spaces import sample_batch

    worst = {}
    for env_id in GOLDEN_IDS:
        want = json.loads((ROOT / "tests" / "golden" / f"{env_id}.json")
                          .read_text())
        b = want["batch"]
        pool = repro_torch.make_vec(env_id, b, backend=backend, device=device)
        h = pool.xla()
        key = R.PRNGKey(sum(map(ord, env_id)), device)
        ps = h.init(key)
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
    emit({"phase": "golden", "backend": backend, "max_abs_err": worst})


def phase_numbers(device, pools, sync):
    import repro_torch
    from repro_torch import random as R

    key = R.PRNGKey(2, device)
    rows = []
    runs = [(env_id, B_MAIN, pool) for env_id, pool in pools.items()]
    small = repro_torch.make_vec("CartPole-v1", B_SMALL, unroll=K, device=device)
    small.rollout(STEPS, key)
    runs.append(("CartPole-v1", B_SMALL, small))
    for env_id, b, pool in runs:
        sec = timed(lambda: pool.rollout(STEPS, key), TIMED_RUNS, sync)
        rows.append({"id": env_id, "B": b, "steps": STEPS, "unroll": K,
                     "seconds_median": sec, "env_steps_per_s": b * STEPS / sec})
    emit({"phase": "numbers", "timed_runs": TIMED_RUNS, "clock":
          "host perf_counter around rollout + synchronize", "rows": rows})
    return {r["id"]: r for r in rows if r["B"] == B_MAIN}


def phase_split(torch, device, pool, sync, numbers):
    """Per-chunk cost of each layer of a fused CartPole-v1 chunk."""
    from repro_torch import random as R
    from repro_torch.core.spaces import sample_batch
    from repro_torch.kernels.envstep import (fresh_rows, lookup, megastep_cuda,
                                             megastep_ref)
    from repro_torch.kernels.envstep.ops import state_rows

    env = pool.env
    spec, max_steps = lookup(env)
    key = R.PRNGKey(3, device)
    state = pool.xla().init(R.PRNGKey(0, device)).env_state
    acts = sample_batch(pool.action_space,
                        R.fold_in(key, torch.arange(1, K + 1, device=device)),
                        B_MAIN).to(torch.float32).contiguous()
    _, fresh, fobs = fresh_rows(env, state.key, K)
    rows = state_rows(spec, max_steps, state.inner).contiguous()
    ops = (rows, acts, fresh, fobs)

    launches = megastep_cuda.launches
    # the kernel against its plain version at the main path's own shapes
    err = compare(torch, megastep_cuda(spec.kernel_id, *ops,
                                       max_steps=max_steps),
                  megastep_ref(spec.step_rows, *ops, max_steps=max_steps),
                  f"CartPole-v1 main-path chunk B={B_MAIN}")
    n = 50
    for _ in range(3):
        megastep_cuda(spec.kernel_id, *ops, max_steps=max_steps)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        megastep_cuda(spec.kernel_id, *ops, max_steps=max_steps)
    end.record()
    sync()
    kernel_ms = start.elapsed_time(end) / n
    start.record()
    for _ in range(5):
        megastep_ref(spec.step_rows, *ops, max_steps=max_steps)
    end.record()
    sync()
    plain_ms = start.elapsed_time(end) / 5
    megastep_cuda.launches = launches        # timing launches are not counted

    steps = torch.arange(1, K + 1, device=device)
    precompute_ms = 1e3 * timed(lambda: fresh_rows(env, state.key, K), 5, sync)
    sampling_ms = 1e3 * timed(
        lambda: sample_batch(pool.action_space, R.fold_in(key, steps), B_MAIN),
        5, sync)
    chunk_ms = 1e3 * numbers["CartPole-v1"]["seconds_median"] / (STEPS // K)
    emit({"phase": "split", "id": "CartPole-v1", "B": B_MAIN, "K": K,
          "max_abs_err_vs_plain": err,
          "per_chunk_ms": {"rollout_chunk": chunk_ms, "kernel": kernel_ms,
                           "fresh_reset_precompute": precompute_ms,
                           "action_sampling": sampling_ms},
          "clock": "kernel: CUDA events over 50 launches; others: host "
                   "perf_counter + synchronize, median of 5"})
    return kernel_ms, plain_ms, spec, err


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
    bw, flops = card_rates(name)
    phase_build()
    max_err = phase_kernel(torch, device)
    pools, launches = phase_main(torch, device, sync)
    phase_parity(torch, device)
    phase_golden(device, "cuda")
    numbers = phase_numbers(device, pools, sync)
    kernel_ms, plain_ms, spec, split_err = phase_split(
        torch, device, pools["CartPole-v1"], sync, numbers)
    max_err = max(max_err, split_err)

    sp = spec.state_size + 1
    bytes_moved = megastep_bytes(B_MAIN, K, sp, spec.obs_size)
    bytes_ms = 1e3 * bytes_moved / bw
    ops_ms = 1e3 * B_MAIN * K * CARTPOLE_OPS_PER_LANE_STEP / flops
    emit({"kernels": [{
        "name": "megastep",
        "route": "cuda",
        "source": "src/repro_torch/csrc/megastep.cu",
        "replaces": "src/repro/kernels/envstep/megastep.py:80",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": {"id": "CartPole-v1", "B": B_MAIN, "K": K,
                  "bytes": bytes_moved},
        "card": smi,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
