"""Serving driver: batched requests against a ported arch (port of
`repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --requests 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --no-reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b --no-reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --no-reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --no-reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m --no-reduced

The first serves the reduced config, the others the full ones (Yi-6B at 32
layers, 24.2 GB of f32 params; OLMoE-1B-7B, 27.7 GB; Granite-MoE 1B-A400M;
zamba2-2.7B, 54 blocks, 8.4 GB; xLSTM-350M, 24 blocks, 1.5 GB); all run on
the CUDA card, or on `--device cpu`. Params are random, drawn from
`--seed`. An MLA arch (minicpm3-4b) is refused before its params are
drawn: the engine's per-slot decode cannot run MLA (serving/engine.py::
check_servable); so is an encoder-decoder arch (whisper-base), whose
prefill needs audio frames that a text request does not carry.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serving.engine import Request, ServeEngine, check_servable


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="yi-6b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card when omitted")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.is_encoder_decoder:
        raise SystemExit("use a decoder-only arch for the text-serving driver")
    check_servable(cfg)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, device)
    engine = ServeEngine(cfg, params, slots=args.slots, max_seq=args.max_seq,
                         device=device)
    del params

    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(rng.integers(4, 32))),
                max_new_tokens=args.max_new)
        for i in range(args.requests)
    ]
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    engine.run(max_ticks=args.requests * (args.max_new + 4))
    dt = time.perf_counter() - t0
    tokens = sum(len(r.output or []) for r in reqs)
    print(f"{args.arch}: served {len(reqs)} requests / {tokens} tokens in {dt:.2f}s "
          f"({tokens / dt:,.1f} tok/s, {args.slots}-slot continuous batching, "
          f"{device})")
    return reqs


if __name__ == "__main__":
    main()
