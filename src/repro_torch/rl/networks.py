"""Policy/value networks (port of `repro.rl.networks`): init/apply pairs
over plain param trees.

The params keep the JAX package's structure and layouts: a dense layer's
`w` is (in, out) and a conv's is HWIO (kh, kw, cin, cout), so a snapshot
reads the same in both packages and carrying weights across is a plain map
(`rl.dqn.params_from_numpy`). `cnn_apply` convolves in NCHW, as cuDNN
prefers, and moves channels last before the flatten, so the dense layer's
rows follow (h, w, c) as in the JAX package's NHWC flatten.
"""
from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random as R


def _elu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.elu`: expm1 of the non-positive part only, so a large
    positive input puts no inf (and no NaN gradient) into the branch the
    select drops."""
    pos = x > 0
    return torch.where(pos, x, torch.expm1(torch.where(pos, 0.0, x)))


Activation = {
    "elu": _elu,
    "relu": torch.relu,
    "tanh": torch.tanh,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}

CONV_SPECS = [  # (kernel_h, kernel_w, stride) per conv layer
    (8, 8, 4),
    (4, 4, 2),
]


@contextlib.contextmanager
def f32_convs():
    """cuDNN convolutions in float32, not TF32, and by deterministic
    algorithms, inside the block.

    PyTorch lets cuDNN run float32 convolutions in TF32 by default, which
    is far outside the port's 1e-5 contract, and pick algorithms whose
    weight gradients sum in a varying order: two runs of the Pong-v0 CNN
    from one seed then part at the first learning step, and a fused run
    cannot equal its host-alternating run bit for bit. The caller's
    settings are put back on exit. (`torch.backends.cudnn.flags` is not
    used: it resets every flag it is not given, `enabled` to False among
    them.)
    """
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = saved


def _scale(fan_in: int) -> float:
    """`jnp.sqrt(2.0 / fan_in)`: the quotient rounded to float32, then a
    float32 square root."""
    return float(np.sqrt(np.float32(2.0 / fan_in)))


def mlp_init(key: torch.Tensor, sizes: Sequence[int]):
    """He-normal dense layers on the key's device, as the JAX package draws
    them (one `split` per layer)."""
    params = []
    for i in range(len(sizes) - 1):
        key, sub = R.split(key)
        w = R.normal(sub, (sizes[i], sizes[i + 1])) * _scale(sizes[i])
        b = torch.zeros(sizes[i + 1], dtype=torch.float32, device=key.device)
        params.append({"w": w, "b": b})
    return params


def mlp_apply(params, x: torch.Tensor, activation: str = "elu"):
    act = Activation[activation]
    x = x.to(params[0]["w"].dtype)   # integer observations, as jnp promotes
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = act(x)
    return x


def cnn_init(key: torch.Tensor, in_shape: Tuple[int, ...], channels=(16, 32),
             dense=256, out=2):
    """Nature-DQN-lite conv net.

    in_shape: (H, W) single grayscale frames, or (N, H, W) for stacked
    frames (core.wrappers.FrameStack) — the stack axis becomes the N input
    channels, the classic Atari-DQN pipeline.
    """
    if len(in_shape) == 2:
        cin, (h, w) = 1, in_shape
    elif len(in_shape) == 3:
        cin, h, w = in_shape
        if cin == 1:
            # cnn_apply infers the layout from the conv fan-in, and cin == 1
            # is indistinguishable from unstacked (H, W) frames at apply
            # time — a 1-frame stack would silently fold into the batch.
            raise ValueError("1-frame stacks are ambiguous: use in_shape="
                             "(H, W) (drop the FrameStack) or >= 2 frames")
    else:
        raise ValueError(f"cnn obs must be (H, W) or (N, H, W); got {in_shape}")
    zeros = lambda n: torch.zeros(n, dtype=torch.float32, device=key.device)
    params = {"convs": [], "dense": None, "out": None}
    for (kh, kw, s), cout in zip(CONV_SPECS, channels):
        key, sub = R.split(key)
        params["convs"].append({
            "w": R.normal(sub, (kh, kw, cin, cout)) * _scale(kh * kw * cin),
            "b": zeros(cout),
        })
        h = (h - kh) // s + 1
        w = (w - kw) // s + 1
        cin = cout
    flat = h * w * cin
    key, k1, k2 = R.split(key, 3)
    params["dense"] = {"w": R.normal(k1, (flat, dense)) * _scale(flat),
                       "b": zeros(dense)}
    params["out"] = {"w": R.normal(k2, (dense, out)) * _scale(dense),
                     "b": zeros(out)}
    return params


def cnn_apply(params, x: torch.Tensor, activation: str = "elu"):
    """x: (..., H, W) grayscale or (..., N, H, W) stacked frames -> (..., out).

    The input layout is recovered from the first conv's fan-in: cin == 1
    means plain (H, W) frames, cin > 1 means an N-frame stack whose leading
    axis maps to input channels. The convolutions run in float32 by
    deterministic algorithms (`f32_convs`), never TF32.
    """
    act = Activation[activation]
    cin = params["convs"][0]["w"].shape[2]
    nd = 2 if cin == 1 else 3
    batch_shape = x.shape[:-nd]
    if cin == 1:
        x = x.reshape((-1, 1) + x.shape[-2:])                 # (B, 1, H, W)
    else:
        x = x.reshape((-1,) + x.shape[-3:])                   # (B, N, H, W)
    with f32_convs():
        for conv, (_, _, s) in zip(params["convs"], CONV_SPECS):
            w = conv["w"].permute(3, 2, 0, 1)                 # HWIO -> OIHW
            x = act(F.conv2d(x, w, stride=s) + conv["b"][:, None, None])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)          # NHWC flatten
    x = act(x @ params["dense"]["w"] + params["dense"]["b"])
    x = x @ params["out"]["w"] + params["out"]["b"]
    return x.reshape(batch_shape + (x.shape[-1],))


__all__ = ["Activation", "CONV_SPECS", "cnn_apply", "cnn_init", "f32_convs",
           "mlp_apply", "mlp_init"]
