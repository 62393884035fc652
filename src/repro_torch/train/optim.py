"""Optimizers, schedules and losses (port of `repro.train.optim`).

Pure functions over param trees (lists, dicts and tuples of tensors), as in
the JAX package: `Adam(...).update(grads, state, params)` returns new
params and a new `AdamState` and changes nothing it was given;
`Adam.update_` is the same update written in place (the JAX launcher's
donated buffers), for states that do not fit twice. The update
is the JAX package's formula, rounded as it is written there; it is not
`torch.optim.Adam`, which folds the bias corrections into the step size
and rounds otherwise. A learning rate or step that lives on the device
stays there: nothing here reads a tensor back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                 tree_unflatten)

from repro_torch.numerics import div, sqrt

Pytree = Any


class AdamState(NamedTuple):
    step: torch.Tensor      # () int32
    mu: Pytree
    nu: Pytree


def _step0(params: Pytree) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam/AdamW. lr may be a float, a 0-dim tensor or a schedule fn
    step -> lr."""

    lr: Any = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = None

    def init(self, params: Pytree) -> AdamState:
        return AdamState(step=_step0(params),
                         mu=tree_map(torch.zeros_like, params),
                         nu=tree_map(torch.zeros_like, params))

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    def update(self, grads: Pytree, state: AdamState,
               params: Pytree) -> Tuple[Pytree, AdamState]:
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * (g * g), state.nu,
                      grads)
        t = step.to(torch.float32)
        mu_hat_scale = 1.0 / (1 - torch.pow(b1, t))
        nu_hat_scale = 1.0 / (1 - torch.pow(b2, t))
        lr = self._lr(step)

        def upd(p, m, v):
            u = (m * mu_hat_scale) / (sqrt(v * nu_hat_scale) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            return (p - lr * u).to(p.dtype)

        return tree_map(upd, params, mu, nu), AdamState(step, mu, nu)

    def update_(self, grads: Pytree, state: AdamState,
                params: Pytree) -> Tuple[Pytree, AdamState]:
        """`update` with the JAX launcher's donation (`donate_argnums`):
        the same arithmetic, leaf by leaf, written into `params` and the
        state's mu and nu in place, which it returns. Beside the state and
        the gradients it holds one leaf's temporaries, where `update` holds
        new params, mu and nu and the clipped gradients whole."""
        scale = (clip_scale(grads, self.clip_norm)
                 if self.clip_norm is not None else None)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        t = step.to(torch.float32)
        mu_hat_scale = 1.0 / (1 - torch.pow(b1, t))
        nu_hat_scale = 1.0 / (1 - torch.pow(b2, t))
        lr = self._lr(step)

        def upd_(p, g, m, v):
            if scale is not None:
                g = (g * scale).to(g.dtype)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * (g * g))
            u = (m * mu_hat_scale) / (sqrt(v * nu_hat_scale) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            return p.copy_((p - lr * u).to(p.dtype))

        return (tree_map(upd_, params, grads, state.mu, state.nu),
                AdamState(step, state.mu, state.nu))


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: Any = 1e-2
    momentum: float = 0.0

    def init(self, params):
        if self.momentum == 0.0:
            return AdamState(_step0(params), None, None)
        return AdamState(_step0(params), tree_map(torch.zeros_like, params),
                         None)

    def update(self, grads, state, params):
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        if self.momentum == 0.0:
            new = tree_map(lambda p, g: p - lr * g, params, grads)
            return new, AdamState(step, None, None)
        mu = tree_map(lambda m, g: self.momentum * m + g, state.mu, grads)
        new = tree_map(lambda p, m: p - lr * m, params, mu)
        return new, AdamState(step, mu, None)


def value_and_grad(loss_fn: Callable, params: Pytree):
    """(loss, grads): `loss_fn(params)` and its gradients over the param
    tree, by `torch.autograd.grad` on detached copies of the leaves; a leaf
    the loss does not reach gets zeros, as in JAX."""
    leaves, spec = tree_flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(leaves, spec))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(list(grads), spec)


def global_norm(tree: Pytree) -> torch.Tensor:
    return sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_scale(tree: Pytree, max_norm: float) -> torch.Tensor:
    """min(max_norm / global_norm(tree), 1): the factor of
    `clip_by_global_norm`."""
    norm = global_norm(tree)
    # a tensor numerator: `float / tensor` is a reciprocal and a multiply
    return torch.clamp(norm.new_full((), max_norm)
                       / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(tree: Pytree, max_norm: float) -> Pytree:
    scale = clip_scale(tree, max_norm)
    return tree_map(lambda x: (x * scale).to(x.dtype), tree)


# -- schedules ---------------------------------------------------------------
def linear_schedule(start: float, end: float, steps: int) -> Callable:
    def fn(step):
        frac = torch.clamp(div(step.to(torch.float32), max(steps, 1)),
                           0.0, 1.0)
        return start + frac * (end - start)

    return fn


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.0) -> Callable:
    def fn(step):
        s = step.to(torch.float32)
        warm = div(peak * s, max(warmup, 1))
        prog = torch.clamp(div(s - warmup, max(total - warmup, 1)), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)

    return fn


# -- losses shared by learners ----------------------------------------------
def huber_loss(pred: torch.Tensor, target: torch.Tensor,
               delta: float = 1.0) -> torch.Tensor:
    err = pred - target
    abs_err = torch.abs(err)
    quad = torch.clamp(abs_err, max=delta)
    return 0.5 * (quad * quad) + delta * (abs_err - quad)


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """logits (..., V), integer labels (...). Returns per-position loss."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - gold


__all__ = ["Adam", "AdamState", "SGD", "clip_by_global_norm", "clip_scale",
           "cosine_schedule", "global_norm", "huber_loss", "linear_schedule",
           "softmax_cross_entropy", "value_and_grad"]
