"""Training launcher: any registry arch, fault-tolerant (port of
`repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch yi-6b --steps 20 --batch 4 --seq 32 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch h2o-danube-1.8b --no-reduced --batch 4 --seq 2048 --remat dots

The first trains a reduced config on the CPU; the second trains
h2o-danube-1.8b at full width and depth on the CUDA card (the default
device). Params are random, drawn from seed 0; the data is the Markov
stream of data/synthetic.py; Whisper's stub frames are
`random.normal(PRNGKey(step))`, as in the JAX launcher. The step
(train/trainer.py) updates params and optimizer state in place, as the JAX
launcher donates them to its jitted step, so a model holds f32 params,
gradients and Adam's mu and nu once, 16 bytes a param, plus the
activations: h2o-danube-1.8b (1.83 B params, 29 GB) fits one 80 GB card;
Yi-6B (97 GB) and OLMoE-1B-7B (111 GB) do not, and the card's
out-of-memory error says so.

Checkpoints: with `--ckpt-dir`, the state after step s (s + 1 steps done)
is saved under s + 1 every `--ckpt-every` steps and at the end, and
`--resume` continues from the latest, so a resumed run gives the losses of
an uninterrupted one. (The JAX launcher saves it under s, and its resume
runs step s twice.)
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import random
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.synthetic import DataConfig, batch_at_step
from repro_torch.device import resolve_device
from repro_torch.models.stack import REMAT
from repro_torch.runtime.straggler import StragglerTracker
from repro_torch.train.trainer import (TrainConfig, init_train_state,
                                       make_train_step)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="yi-6b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=REMAT)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card when omitted")
    return ap.parse_args(argv)


def batch_at(cfg, dc: DataConfig, step: int, device) -> dict:
    """Step `step`'s batch as tensors on `device`, with Whisper's frames."""
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in batch_at_step(dc, step).items()}
    if cfg.is_encoder_decoder:
        batch["frames"] = random.normal(
            random.PRNGKey(step, device),
            (dc.global_batch, cfg.encoder_len, cfg.d_model))
    return batch


def train(args: argparse.Namespace) -> dict:
    """The training loop. Returns {"tc", "dc", "device", "params", "opt",
    "step_fn", "history": one {"step", "loss", "grad_norm", "lr",
    "seconds"} a step run (host clock around the step, which ends on the
    loss read back)}."""
    cfg = get_config(args.arch, reduced=args.reduced)
    device = resolve_device(args.device)
    tc = TrainConfig(lr=args.lr, warmup=max(args.steps // 20, 1),
                     total_steps=args.steps, remat=args.remat,
                     accum_steps=args.accum)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch, kind="markov")

    params, opt = init_train_state(
        cfg, tc, torch.Generator(device=device).manual_seed(0), device)
    start_step = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr and args.resume and mgr.latest_step() is not None:
        state = mgr.restore({"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
        start_step = mgr.latest_step()
        print(f"resumed from step {start_step}")

    step_fn = make_train_step(cfg, tc)
    tracker = StragglerTracker(num_hosts=1)
    history = []
    t_start = time.perf_counter()
    for step in range(start_step, args.steps):
        batch = batch_at(cfg, dc, step, device)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        seconds = time.perf_counter() - t0
        tracker.record(0, seconds)
        history.append({"step": step, "loss": loss,
                        "grad_norm": float(metrics["grad_norm"]),
                        "lr": float(metrics["lr"]), "seconds": seconds})
        if step % args.log_every == 0 or step == args.steps - 1:
            tps = args.batch * args.seq / max(seconds, 1e-9)
            print(f"step {step:5d} loss {loss:.4f} grad_norm "
                  f"{history[-1]['grad_norm']:.3f} tok/s {tps:,.0f}")
        if mgr and (step + 1) % args.ckpt_every == 0 and step + 1 < args.steps:
            mgr.save(step + 1, {"params": params, "opt": opt}, blocking=False)
    if mgr:
        mgr.save(args.steps, {"params": params, "opt": opt})
        mgr.close()
    final = history[-1]["loss"] if history else float("nan")
    print(f"done in {time.perf_counter() - t_start:.1f}s; final loss "
          f"{final:.4f} (uniform = {np.log(cfg.vocab_size):.3f})")
    return {"tc": tc, "dc": dc, "device": device,
            "params": params, "opt": opt, "step_fn": step_fn,
            "history": history}


def main(argv=None) -> dict:
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
