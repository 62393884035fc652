"""Deterministic synthetic data pipeline (host-sharded, restart-exact): the
port's own copy of `repro.data.synthetic` (numpy only), giving the same
batches bit for bit.

Every batch is a pure function of (seed, step, host_id), so:
  - restarts replay the exact stream from the checkpointed step (no data
    loss / duplication across failures: the fault-tolerance contract);
  - each host materialises only its slice of the global batch;
  - elastic re-scaling re-slices the same global stream.

Two generators (`DataConfig.kind`):
  - "random" : uniform tokens (throughput benchmarking)
  - "markov" : an order-1 Markov chain with a banded transition matrix,
    which has real, learnable structure, so training losses visibly drop
    below log(V).
Batches are numpy int32; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "markov"     # markov | random
    num_hosts: int = 1
    host_id: int = 0


def _rng(cfg: DataConfig, step: int) -> np.random.Generator:
    # Philox keyed on (seed, step, host): O(1) seek to any step.
    key = (np.uint64(cfg.seed) << np.uint64(32)) ^ np.uint64(step)
    return np.random.Generator(np.random.Philox(key=[key, np.uint64(cfg.host_id)]))


def _markov_matrix(vocab: int, seed: int):
    """(successors (V, 8), their probabilities (V, 8)): 8 plausible
    successors per token."""
    rng = np.random.Generator(np.random.Philox(key=[np.uint64(seed), np.uint64(0xBEEF)]))
    base = rng.random((vocab, 8))
    succ = (np.arange(vocab)[:, None] * 7 + np.arange(8)[None] * 13 + 1) % vocab
    probs = base / base.sum(-1, keepdims=True)
    return succ, probs


def batch_at_step(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """This host's slice of the global batch of `step`: {"tokens", "labels"},
    each (global_batch // num_hosts, seq_len) int32, labels the tokens
    shifted by one."""
    local_batch = cfg.global_batch // cfg.num_hosts
    rng = _rng(cfg, step)
    if cfg.kind == "random":
        tokens = rng.integers(0, cfg.vocab_size, (local_batch, cfg.seq_len + 1), dtype=np.int32)
    else:
        succ, probs = _markov_matrix(cfg.vocab_size, cfg.seed)
        tokens = np.empty((local_batch, cfg.seq_len + 1), np.int32)
        tokens[:, 0] = rng.integers(0, cfg.vocab_size, local_batch)
        # vectorised chain: pick one of 8 successors per position
        choices = rng.random((local_batch, cfg.seq_len))
        for t in range(cfg.seq_len):
            p = probs[tokens[:, t]]                      # (B, 8)
            cum = np.cumsum(p, axis=-1)
            pick = (choices[:, t : t + 1] < cum).argmax(-1)
            tokens[:, t + 1] = succ[tokens[:, t], pick]
    return {
        "tokens": tokens[:, :-1],
        "labels": tokens[:, 1:].astype(np.int32),
    }


def stream(cfg: DataConfig, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_at_step(cfg, step)
        step += 1


__all__ = ["DataConfig", "batch_at_step", "stream"]
