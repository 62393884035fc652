"""Decoder-only LM: init / forward / prefill / decode (port of
`repro.models.lm`, for models built of "full", "swa", "mla" and "full_moe"
blocks).

Params are the JAX package's tree as plain dicts of tensors: "embed",
"final_scale", "segments" (a list of {"b{i}": block} dicts whose leaves
are stacked over layers) and "lm_head" when the embeddings are untied, so
`params_from_numpy` carries the JAX params across as a tree map. The LM
head is tied to the embedding by default. `loss_fn` waits for the training
port (ROADMAP A13).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import dense_init, embed_init, rms_norm
from repro_torch.models.stack import (check_ported, stack_apply,
                                      stack_cache_init, stack_decode,
                                      stack_init, stack_prefill)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for a model with
    a block kind the port does not build yet."""
    for blocks, _ in cfg.segments + cfg.encoder_segments:
        for kind in blocks:
            check_ported(kind)


def tree_map(fn, tree):
    """`fn` over every leaf of a params tree (nested dicts and lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    """The tensors of nested dicts, lists and tuples (caches' `KVCache`s
    too), in order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None) -> Dict[str, Any]:
    """Random params on `device` (the CUDA card when None; raises without
    one), drawn from `gen`, which must live on that device."""
    check_supported(cfg)
    device = resolve_device(device)
    if gen.device.type != device.type:
        raise ValueError(f"the generator is on {gen.device}, the params go "
                         f"to {device}")
    pdt = _pdtype(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, pdt),
        "final_scale": torch.zeros((cfg.d_model,), dtype=pdt, device=gen.device),
        "segments": stack_init(gen, cfg, cfg.segments, pdt),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), pdt)
    return params


def params_from_numpy(tree, device) -> Any:
    """The JAX package's params, as numpy arrays
    (`jax.tree.map(np.asarray, params)`), to tensors on `device`; lists and
    dicts keep their structure."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


#: the params that are matrices, by key: the embedding, the LM head and
#: every projection (MLA's down- and up-projections, the MoE router and
#: expert matrices among them). The norm scales stay in the param dtype.
MATRICES = frozenset({"embed", "lm_head", "wq", "wk", "wv", "wo", "w_in",
                      "w_out", "w_dq", "w_uq", "w_dkv", "w_ukv", "router"})


def compute_params(cfg: ModelConfig, params) -> Any:
    """`params` with every matrix (by key, `MATRICES`; stacked over layers
    or not) cast to the compute dtype once, norm scales as they are. Every
    use of a matrix casts it to the compute dtype (`x @ w.to(x.dtype)`, the
    embedding gather then cast) and every norm upcasts its scale to f32, so
    the numbers are the same; the per-call cast, 24 GB read and 12 GB
    written per decode step at Yi-6B in bf16, is gone. The copy is new
    memory beside `params` (half of it, in bf16 from f32)."""
    dt = _dtype(cfg)

    def cast(tree, key=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v) for v in tree]
        return tree.to(dt) if key in MATRICES else tree

    return cast(params)


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """Returns (hidden (B, L, d), aux loss: the MoE blocks' load-balance
    losses summed, an f32 0 for a dense model)."""
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    x = params["embed"][tokens.long()].to(_dtype(cfg))
    positions = torch.arange(tokens.shape[1], device=x.device)
    x, aux = stack_apply(params["segments"], cfg, cfg.segments, x,
                         positions=positions)
    return rms_norm(x, params["final_scale"], cfg.norm_eps), aux


def logits_for(cfg: ModelConfig, params, hidden: torch.Tensor) -> torch.Tensor:
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    h = head.T if cfg.tie_embeddings else head
    return (hidden @ h.to(hidden.dtype)).float()


# -------------------------------------------------------------------- serving
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    return stack_cache_init(cfg, cfg.segments, batch, max_seq, _dtype(cfg),
                            resolve_device(device))


def prefill(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], max_seq: int):
    """Run the prompt through the stack, filling new caches. Returns
    (last_logits (B, 1, V), caches)."""
    device = params["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=device)
    b, l = tokens.shape
    caches = init_cache(cfg, b, max_seq, device)
    x = params["embed"][tokens.long()].to(_dtype(cfg))
    positions = torch.arange(l, device=device)
    x, caches = stack_prefill(params["segments"], caches, cfg, cfg.segments, x,
                              positions=positions)
    x = rms_norm(x, params["final_scale"], cfg.norm_eps)
    return logits_for(cfg, params, x[:, -1:]), caches


def decode_step(cfg: ModelConfig, params, caches, tokens: torch.Tensor, pos):
    """tokens: (B, 1) the token decoded at absolute position `pos` (an int
    or 0-d tensor, or a (B,) tensor per slot). Writes `caches` in place and
    returns (logits (B, V), caches)."""
    device = params["embed"].device
    tokens = torch.as_tensor(tokens, device=device)
    x = params["embed"][tokens.long()].to(_dtype(cfg))
    x, caches = stack_decode(params["segments"], caches, cfg, cfg.segments, x,
                             pos)
    x = rms_norm(x, params["final_scale"], cfg.norm_eps)
    return logits_for(cfg, params, x)[:, 0], caches


__all__ = ["MATRICES", "check_supported", "compute_params", "decode_step", "forward",
           "tree_leaves", "tree_map",
           "init_cache", "init_params", "logits_for", "params_from_numpy",
           "prefill"]
