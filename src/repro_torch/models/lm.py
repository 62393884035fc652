"""Unified LM: init / forward / prefill / decode for every family (port of
`repro.models.lm`).

Families:
  decoder-only ("dense"/"moe"/"ssm"/"hybrid"/"vlm"): tokens -> logits.
  encoder-decoder ("audio", whisper): stub frame embeddings -> encoder;
  tokens -> decoder with cross attention (`batch["frames"]`, (B, T, d):
  the conv frontend is a stub in the JAX package too).

Params are the JAX package's tree as plain dicts of tensors: "embed",
"final_scale", "segments" (a list of {"b{i}": block} dicts whose leaves
are stacked over layers), "lm_head" when the embeddings are untied,
"shared" (zamba2's one attention + FFN, used at every "attn_shared"
site) and "enc_segments" / "enc_final_scale" (Whisper's encoder), so
`params_from_numpy` carries the JAX params across as a tree map. The LM
head is tied to the embedding by default. `loss_fn` is the training loss:
the chunked cross entropy (no (B, L, V) logits) plus `AUX_WEIGHT` times the
MoE blocks' load-balance losses; `forward` and `encode` take the JAX
package's `remat` policy (models/stack.py).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import (chunked_cross_entropy, dense_init,
                                       embed_init, rms_norm)
from repro_torch.models.attention import cross_kv
from repro_torch.kernels import is_dtensor
from repro_torch.sharding import rules
from repro_torch.sharding.rules import BATCH_AXES, shard_hint
from repro_torch.models.stack import (check_ported, shared_block_init,
                                      stack_apply, stack_cache_init,
                                      stack_decode, stack_init, stack_prefill)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: weight of the MoE load-balance loss in `loss_fn`
AUX_WEIGHT = 0.01


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError for a model with a block kind the stack does not
    know."""
    for blocks, _ in cfg.segments + cfg.encoder_segments:
        for kind in blocks:
            check_ported(kind)


def _has_shared(cfg: ModelConfig) -> bool:
    return any("attn_shared" in blocks for blocks, _ in cfg.segments)


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
    if _has_shared(cfg):
        params["shared"] = shared_block_init(gen, cfg, pdt)
    if cfg.is_encoder_decoder:
        params["enc_segments"] = stack_init(gen, cfg, cfg.encoder_segments, pdt)
        params["enc_final_scale"] = torch.zeros((cfg.d_model,), dtype=pdt,
                                                device=gen.device)
    return params


def params_from_numpy(tree, device) -> Any:
    """The JAX package's params, as numpy arrays
    (`jax.tree.map(np.asarray, params)`), to tensors on `device`; lists and
    dicts keep their structure."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


#: the params that are matrices, by key: the embedding, the LM head and
#: every projection (MLA's down- and up-projections, the MoE router and
#: expert matrices, the mLSTM's, sLSTM's input and MLP matrices, Mamba2's
#: conv weights among them), each cast to the compute dtype wherever the
#: JAX package uses it. The rest stay in the param dtype: the norm scales,
#: the biases, and what the recurrent blocks compute with in f32 (sLSTM's
#: recurrent `r`, Mamba2's `a_log`, `dt_bias`, `d_skip`).
MATRICES = frozenset({"embed", "lm_head", "wq", "wk", "wv", "wo", "w_in",
                      "w_out", "w_dq", "w_uq", "w_dkv", "w_ukv", "router",
                      "w_x", "w_z", "w_q", "w_k", "w_g", "w_down", "w",
                      "mlp_in", "mlp_out", "conv_w"})


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


def encode(cfg: ModelConfig, params, frames, remat: str = "none") -> torch.Tensor:
    """Encoder side (whisper): frames (B, T, d) stub embeddings -> (B, T, d)
    (batch-sharded frames, `place_batch`'s, for DTensor params)."""
    if not is_dtensor(frames):
        frames = torch.as_tensor(frames, device=params["embed"].device)
    x = shard_hint(frames.to(_dtype(cfg)), BATCH_AXES, None, None)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = stack_apply(params["enc_segments"], cfg, cfg.encoder_segments, x,
                       positions=positions, remat=remat)
    return rms_norm(x, params["enc_final_scale"], cfg.norm_eps)


def _encode_batch(cfg: ModelConfig, params, batch, remat: str = "none"):
    return (encode(cfg, params, batch["frames"], remat)
            if cfg.is_encoder_decoder else None)


def place_batch(batch, params):
    """`batch` on the params' device; on their mesh where they are DTensors,
    laid out by `rules.batch_specs` (every rank holds the whole batch, as
    every host does in the JAX launcher, and keeps its own rows; a value
    that is a DTensor already is kept). The params are sharded or not as
    their embedding is."""
    embed = params["embed"]
    if not is_dtensor(embed):
        return {k: torch.as_tensor(v, device=embed.device)
                for k, v in batch.items()}
    mesh = embed.device_mesh
    shardings = rules.to_shardings(rules.batch_specs(mesh, batch), mesh)
    return {k: v if is_dtensor(v) else rules.distribute(
                torch.as_tensor(v, device=embed.device), shardings[k])
            for k, v in batch.items()}


def _sharded(params) -> bool:
    return is_dtensor(params["embed"])


def _embed(cfg: ModelConfig, params, tokens) -> torch.Tensor:
    """The token rows (`embed_rows`: each rank's own rows of a
    vocab-sharded table), pinned to batch-sharded rows."""
    x = embed_rows(params["embed"], tokens.long()).to(_dtype(cfg))
    return shard_hint(x, BATCH_AXES, None, None)


def embed_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`table[ids]`. For a DTensor table, each rank's rows (`local_map`),
    as GSPMD partitions the gather: the table's FSDP shards gathered
    (`gathered`), each rank taking the rows its vocab shard holds and
    zeros elsewhere, the rows a partial sum over the mesh dims that split
    the vocab; their gradient lands in the rank's own vocab shard.
    DTensor's own gather, and its backward's `index_put`, fail on some
    layouts (torch 2.11: an unnormalized `Shard(-1)`)."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.rules import gathered, placed

    table = gathered(table)
    mesh = table.device_mesh
    coord = mesh.get_coordinate()
    ids = placed(ids, (Replicate(),) * mesh.ndim, mesh) if not is_dtensor(
        ids) else ids
    rows = [p == Shard(0) and mesh.size(i) > 1
            for i, p in enumerate(ids.placements)]
    vocab, first, width = [], 0, table.shape[0]
    for i, p in enumerate(table.placements):
        vocab.append(p == Shard(0) and mesh.size(i) > 1 and not rows[i])
        if vocab[-1]:
            width //= mesh.size(i)
            first += coord[i] * width
    tp = [Shard(0) if v else Replicate() for v in vocab]
    ip = [Shard(0) if r else Replicate() for r in rows]
    op = [Shard(0) if r else Partial() if v else Replicate()
          for r, v in zip(rows, vocab)]
    tg = [Partial() if r else Shard(0) if v else Replicate()
          for r, v in zip(rows, vocab)]

    def body(t, i):
        if not any(vocab):
            return t[i]
        local = i - first
        mine = (local >= 0) & (local < t.shape[0])
        return torch.where(mine[..., None], t[torch.where(mine, local, 0)], 0.0)

    return local_map(body, out_placements=op, in_placements=(tp, ip),
                     in_grad_placements=(tg, ip), device_mesh=mesh)(
        placed(table, tp), placed(ids, ip))


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            remat: str = "none", *, q_chunk: int | None = None):
    """Returns (hidden (B, L, d), aux loss: the MoE blocks' load-balance
    losses summed, an f32 0 for a dense model). An encoder-decoder model
    reads `batch["frames"]` too. `q_chunk` is the query rows the attention
    backward recomputes at once."""
    tokens = batch["tokens"]
    if not is_dtensor(tokens):
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
    # the rows of the ("model", "data")-sharded embedding for batch-sharded
    # tokens, pinned to batch-sharded rows: the JAX package's pin here fails
    # under jax 0.9 (DuplicateSpecError, "data" on two dims); here the
    # partial rows of the vocab shards are reduced over "model" instead
    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    x, aux = stack_apply(params["segments"], cfg, cfg.segments, x,
                         positions=positions, shared=params.get("shared"),
                         enc_out=_encode_batch(cfg, params, batch, remat),
                         remat=remat, q_chunk=q_chunk)
    return rms_norm(x, params["final_scale"], cfg.norm_eps), aux


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            remat: str = "none", *, ce_chunk: int = 512,
            q_chunk: int | None = None) -> torch.Tensor:
    """The training loss (an f32 scalar): the mean next-token cross entropy
    of `batch["labels"]` (over `batch["mask"]` where given; `ce_chunk`
    positions of logits at a time) plus `AUX_WEIGHT` times the aux loss."""
    hidden, aux = forward(cfg, params, batch, remat, q_chunk=q_chunk)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    device = hidden.device
    mask = batch.get("mask")
    ce = chunked_cross_entropy(
        hidden, head, torch.as_tensor(batch["labels"], device=device),
        mask=None if mask is None else torch.as_tensor(mask, device=device),
        chunk=ce_chunk, transpose_head=cfg.tie_embeddings)
    return ce + AUX_WEIGHT * aux


def logits_for(cfg: ModelConfig, params, hidden: torch.Tensor) -> torch.Tensor:
    """f32 logits of `hidden` by the LM head (the embedding's transpose
    where tied); for DTensors the column-parallel product on each rank's
    vocab shard (`rules.matmul`), the logits left sharded over the vocab."""
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    h = head.T if cfg.tie_embeddings else head
    return rules.matmul(hidden, h.to(hidden.dtype)).float()


# -------------------------------------------------------------------- serving
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None,
               mesh=None, seq_shard_decode: bool = False):
    """Zeroed caches for `batch` rows of `max_seq` positions on `device`;
    with a `mesh`, DTensors laid out by `rules.serve_cache_specs` (batch
    over the data axes, heads over "model"; a batch of 1 puts the sequence,
    or a recurrent state's K dim, over the data axes; `seq_shard_decode`
    the sequence over "model" where the heads are not)."""
    caches = stack_cache_init(cfg, cfg.segments, batch, max_seq, _dtype(cfg),
                              resolve_device(device), enc_len=cfg.encoder_len)
    if mesh is None:
        return caches
    return rules.lay_out_cache(caches, mesh, rules.serve_cache_specs(
        mesh, caches, batch, seq_shard_decode))


def prefill(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            max_seq: int):
    """Run the prompt through the stack, filling new caches (an
    encoder-decoder model's cross K/V first, from `batch["frames"]`).
    Returns (last_logits (B, 1, V), caches). With DTensor params the inputs
    are laid out by `place_batch` and the caches by `init_cache`'s mesh
    rule on the params' mesh."""
    if not _sharded(params):
        return _prefill(cfg, params, place_batch(batch, params), max_seq, None)
    with rules.replicating(True):
        return _prefill(cfg, params, place_batch(batch, params), max_seq,
                        params["embed"].device_mesh)


def _prefill(cfg: ModelConfig, params, batch, max_seq: int, mesh):
    tokens = batch["tokens"]
    device = params["embed"].device
    b, l = tokens.shape
    caches = init_cache(cfg, b, max_seq, device, mesh)
    x = _embed(cfg, params, tokens)
    positions = torch.arange(l, device=device)
    enc_out = _encode_batch(cfg, params, batch)
    if enc_out is not None:
        # compute and store each decoder layer's cross-attention K/V once
        for (_, rep), seg_params, seg_cache in zip(
                cfg.segments, params["segments"], caches):
            cross, cache = seg_params["b0"]["cross"], seg_cache["b0"]
            for layer in range(rep):
                k, v = cross_kv({n: w[layer] for n, w in cross.items()}, cfg,
                                enc_out)
                rules.assign(cache["cross_k"][layer], k)
                rules.assign(cache["cross_v"][layer], v)
    x, caches = stack_prefill(params["segments"], caches, cfg, cfg.segments, x,
                              positions=positions, shared=params.get("shared"),
                              enc_out=enc_out)
    x = rms_norm(x, params["final_scale"], cfg.norm_eps)
    return logits_for(cfg, params, x[:, -1:]), caches


def decode_step(cfg: ModelConfig, params, caches, tokens: torch.Tensor, pos):
    """tokens: (B, 1) the token decoded at absolute position `pos` (an int
    or 0-d tensor, or a (B,) tensor per slot). Writes `caches` in place and
    returns (logits (B, V), caches). With DTensor params and caches (from
    `prefill` or `init_cache(mesh=)`) the tokens are laid out by
    `place_batch`."""
    if not _sharded(params):
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
        return _decode_step(cfg, params, caches, tokens, pos)
    with rules.replicating(True):
        tokens = place_batch({"tokens": tokens}, params)["tokens"]
        return _decode_step(cfg, params, caches, tokens, pos)


def _decode_step(cfg: ModelConfig, params, caches, tokens, pos):
    x = _embed(cfg, params, tokens)
    x, caches = stack_decode(params["segments"], caches, cfg, cfg.segments, x,
                             pos, shared=params.get("shared"))
    x = rms_norm(x, params["final_scale"], cfg.norm_eps)
    return logits_for(cfg, params, x)[:, 0], caches


__all__ = ["AUX_WEIGHT", "MATRICES", "check_supported", "compute_params",
           "decode_step", "embed_rows", "encode", "forward", "init_cache",
           "init_params", "logits_for", "loss_fn", "params_from_numpy",
           "place_batch", "prefill", "tree_leaves", "tree_map"]
