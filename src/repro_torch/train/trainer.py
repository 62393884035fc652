"""Train-step factory: loss -> grads -> optimizer, with the scale knobs (port
of `repro.train.trainer`).

Knobs (`TrainConfig`, the JAX package's fields and defaults):
  - remat        : "none" | "dots" | "full" activation checkpointing
                   (models/stack.py)
  - accum_steps  : gradient accumulation over microbatches (the batch's
                   rows cut into `accum_steps` equal slices, in order),
                   the f32 gradients summed from zeros and scaled by
                   1/accum_steps, as the JAX package's `lax.scan`
  - compress_pod_grads : the int8 round trip of train/compression.py on
                   the gradients before the optimizer

Params are the JAX package's tree (models/lm.py); the optimizer is the
port's `Adam` with its cosine schedule and global-norm clipping. A step's
gradients come from `torch.autograd.grad` of `lm.loss_fn`. On the card its
attention forwards launch the flash kernel, and their gradient is the JAX
package's plain recompute (kernels/attention/ops.py). The step writes the
update into the params and optimizer state it was given (`Adam.update_`),
as the JAX launcher donates them to its jitted step (`donate_argnums`): f32
params, gradients and Adam's mu and nu are held once, 16 bytes a param. It
runs under the profiler ranges `STAGES`.

Sharded over a mesh: params (and Adam's mu and nu, laid out like them)
that are DTensors (`runtime/elastic.py::reshard_state`) make the same step
the JAX package's `jit(in_shardings=(params, opt, batch))`: the batch is
laid out by `sharding.rules.batch_specs` on the params' mesh, the model's
pins and `local_map`s lay out the work, every gradient is redistributed to
its param's placements before the update (JAX's `out_shardings`: DTensor
leaves a weight's gradient a partial sum), and the metrics come back
whole, the same on every rank. The step runs under DTensor's
`implicit_replication`: plain tensors made inside it (positions, masks,
the step count) are replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import is_dtensor
from repro_torch.models import lm
from repro_torch.models.lm import place_batch
from repro_torch.sharding import rules
from repro_torch.train.compression import compress_decompress
from repro_torch.train.optim import (Adam, AdamState, cosine_schedule,
                                     global_norm, value_and_grad)

#: `torch.profiler` ranges of a step: the loss and its gradients (the
#: backward's own ops run on autograd's thread, outside the range), then
#: the optimizer update
STAGES = ("train::grads", "train::update")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    remat: str = "dots"
    accum_steps: int = 1
    compress_pod_grads: bool = False


def make_optimizer(tc: TrainConfig) -> Adam:
    return Adam(lr=cosine_schedule(tc.lr, tc.warmup, tc.total_steps),
                weight_decay=tc.weight_decay, clip_norm=tc.clip_norm)


def loss_and_grads(cfg: ModelConfig, params, batch, remat: str = "none", *,
                   ce_chunk: int = 512, q_chunk: int | None = None):
    """(loss, grads in params' tree) of `lm.loss_fn` on `batch`; a DTensor
    param's gradient laid out as the param."""
    loss, grads = value_and_grad(
        lambda p: lm.loss_fn(cfg, p, batch, remat=remat, ce_chunk=ce_chunk,
                             q_chunk=q_chunk), params)
    return loss, tree_map(lambda g, p: rules.placed(g, p.placements)
                          if is_dtensor(p) else g, grads, params)


def _whole(x):
    """A DTensor metric as one plain tensor, the same on every rank."""
    if not is_dtensor(x):
        return x
    return x.full_tensor()


def make_train_step(cfg: ModelConfig, tc: TrainConfig, *, ce_chunk: int = 512,
                    q_chunk: int | None = None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {"loss", "grad_norm" (of the gradients the optimizer is given,
    before its clipping), "lr" (of this update)}), the update written into
    `params` and `opt_state`'s mu and nu, which it returns. `batch` holds
    tensors or arrays ("tokens", "labels", optionally "mask", and "frames"
    for an encoder-decoder model) and goes to the params' device, or their
    mesh (module docstring). `ce_chunk` is the loss's logits chunk and
    `q_chunk` the attention backward's query chunk (None: `ops.Q_CHUNK`;
    launch/perf.py's knobs)."""
    optimizer = make_optimizer(tc)
    chunks = dict(ce_chunk=ce_chunk, q_chunk=q_chunk)

    def grads_of(params, batch):
        if tc.accum_steps <= 1:
            return loss_and_grads(cfg, params, batch, tc.remat, **chunks)
        a = tc.accum_steps
        rows, rest = divmod(next(iter(batch.values())).shape[0], a)
        if rest:
            raise ValueError(f"a batch of {rows * a + rest} rows does not "
                             f"split into {a} microbatches")
        acc = tree_map(torch.zeros_like, params)
        total = 0.0
        for i in range(a):
            micro = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            loss, grads = loss_and_grads(cfg, params, micro, tc.remat,
                                         **chunks)
            tree_map(lambda x, g: x.add_(g), acc, grads)
            total = total + loss
            del grads
        inv = 1.0 / a
        return total * inv, tree_map(lambda x: x * inv, acc)

    def train_step(params, opt_state: AdamState, batch):
        sharded = is_dtensor(lm.tree_leaves(params)[0])
        with rules.replicating(sharded):
            batch = place_batch(batch, params)
            with torch.profiler.record_function(STAGES[0]):
                loss, grads = grads_of(params, batch)
                if tc.compress_pod_grads:
                    grads = compress_decompress(grads)
            metrics = {"loss": loss, "grad_norm": global_norm(grads),
                       "lr": optimizer._lr(opt_state.step + 1)}
            with torch.profiler.record_function(STAGES[1]):
                params, opt_state = optimizer.update_(grads, opt_state, params)
            if sharded:
                metrics = {k: _whole(v) for k, v in metrics.items()}
        return params, opt_state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, tc: TrainConfig, gen: torch.Generator,
                     device=None):
    """(params drawn from `gen` on `device` (the card when None), a fresh
    `AdamState`)."""
    params = lm.init_params(cfg, gen, device)
    return params, make_optimizer(tc).init(params)


def state_from_numpy(params_np, opt_np, device):
    """The JAX package's params and `AdamState(step, mu, nu)`, as numpy
    (`jax.tree.map(np.asarray, ...)`), to tensors on `device`."""
    step, mu, nu = opt_np
    step = torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device)
    return (lm.params_from_numpy(params_np, device),
            AdamState(step, lm.params_from_numpy(mu, device),
                      lm.params_from_numpy(nu, device)))


__all__ = ["STAGES", "TrainConfig", "init_train_state", "loss_and_grads",
           "make_optimizer", "make_train_step", "place_batch",
           "state_from_numpy"]
