"""Batched serving engine: prefill + decode with continuous slot refill
(port of `repro.serving.engine`).

The decode step runs over a fixed-size slot batch; finished sequences free
their slot and the host-side scheduler refills it by prefilling the next
queued request and splicing its cache rows into the same slot:
  - `_admit` prefills one request alone (batch 1) and copies its cache
    rows into the slot's rows IN PLACE (the JAX engine builds a new cache
    tree; PyTorch can write the rows);
  - `decode_step` advances every slot by one token at its own position;
  - inactive slots are masked by `active`.

Every prefill runs the flash-attention kernel once per layer (on the card);
the per-slot decode is plain PyTorch and launches none (see
models/attention.py). MoE models ("full_moe") decode their slot batch
through `moe_apply` as one batch of tokens, as the JAX engine does, so the
slots' tokens (inactive slots' too) share the experts' capacity. The
recurrent blocks (xLSTM, zamba2's Mamba2) ignore positions: every slot's
state advances each tick, an inactive slot's too, and admit overwrites
its rows, as in the JAX engine; zamba2's shared-attention sites decode
per slot like any GQA block. MLA models and encoder-decoder models are
refused: the JAX engine cannot serve either (see `check_servable`). The
engine keeps its own copy of the params with
every matrix cast to the compute dtype once (`lm.compute_params`): the
same numbers, without a 24 GB cast per decode step at Yi-6B.

Slot bookkeeping (ownership, FIFO admission, queue-wait/residency
accounting) is the shared `serving/slots.SlotTable` (`ServeEngine.stats()`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serving.slots import SlotTable


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (L,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    output: Optional[list] = None


class EngineState(NamedTuple):
    caches: Any
    tokens: torch.Tensor   # (slots, 1) last token per slot
    pos: torch.Tensor      # (slots,) next absolute position per slot
    active: torch.Tensor   # (slots,) bool


def check_servable(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a model the engine cannot serve: one
    with MLA blocks, or an encoder-decoder model. The JAX engine decodes
    with per-slot positions `(slots,)`, and the JAX package's `mla_apply`
    writes its cache with `dynamic_update_slice(..., (0, cache_pos, 0))`,
    which takes scalar indices only, so `repro.serving.engine.ServeEngine`
    raises a TypeError on an MLA model. Its admit prefills with tokens
    only (`src/repro/serving/engine.py:93`), and the JAX package's
    `lm.prefill` reads `batch["frames"]` for an encoder-decoder model
    (`src/repro/models/lm.py:116`), so it raises `KeyError: 'frames'` on
    Whisper. The port adds no feature the reference lacks. Both are served
    by `lm.prefill` and `lm.decode_step` at a scalar position (Whisper's
    with its frames)."""
    lm.check_supported(cfg)
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"ServeEngine does not serve {cfg.name}: an encoder-decoder model "
            f"prefills from its audio frames, and the engine admits a request "
            f"by its tokens alone (the JAX package's ServeEngine raises "
            f"KeyError: 'frames' here). Use lm.prefill with batch['frames'] "
            f"and lm.decode_step")
    if any("mla" in blocks for blocks, _ in cfg.segments):
        raise NotImplementedError(
            f"ServeEngine does not serve {cfg.name}: its MLA blocks take a "
            f"scalar cache position, and the engine decodes every slot at its "
            f"own position (the JAX package's ServeEngine raises a TypeError "
            f"here: mla_apply's dynamic_update_slice takes scalar indices). "
            f"Use lm.prefill and lm.decode_step at a scalar position")


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, slots: int = 8, max_seq: int = 2048,
                 device=None):
        """Serves on `device` (the CUDA card when None; raises without
        one); `params` are moved there and cast once. Decoding is greedy
        (the JAX engine's `temperature` is stored there and never read).
        Raises NotImplementedError for an MLA or encoder-decoder model
        (`check_servable`)."""
        check_servable(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = lm.compute_params(
            cfg, lm.tree_map(lambda x: x.to(self.device), params))
        self.slots = slots
        self.max_seq = max_seq
        self._requests: Dict[int, Request] = {}
        i32 = dict(dtype=torch.int32, device=self.device)
        self.state = EngineState(
            caches=lm.init_cache(cfg, slots, max_seq, self.device),
            tokens=torch.zeros((slots, 1), **i32),
            pos=torch.zeros((slots,), **i32),
            active=torch.zeros((slots,), dtype=torch.bool, device=self.device),
        )
        self.slots_table = SlotTable(slots)

    # -- device programs -------------------------------------------------
    def _decode(self, params, state: EngineState):
        # one step advances every slot; positions are PER-SLOT (the
        # attention cache paths accept vector cache_pos), so heterogeneous
        # requests share one program. The caches are written in place.
        logits, caches = lm.decode_step(self.cfg, params, state.caches,
                                        state.tokens, state.pos)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        tokens = torch.where(state.active, next_tok, state.tokens[:, 0])[:, None]
        pos = torch.where(state.active, state.pos + 1, state.pos)
        return EngineState(caches, tokens, pos, state.active), next_tok

    # -- host scheduler ----------------------------------------------------
    def submit(self, req: Request) -> None:
        req.output = []
        self._requests[req.rid] = req
        self.slots_table.submit(req.rid)

    def _free_slots(self) -> List[int]:
        return self.slots_table.free_slots()

    def _admit(self) -> None:
        for slot, rid in self.slots_table.admit():
            req = self._requests[rid]
            prompt = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int32,
                                     device=self.device)[None]
            # prefill this request alone (batch 1) then splice its cache rows
            logits, cache1 = lm.prefill(self.cfg, self.params,
                                        {"tokens": prompt}, self.max_seq)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            for full, one in zip(lm.tree_leaves(self.state.caches),
                                 lm.tree_leaves(cache1)):
                full[:, slot:slot + 1].copy_(one)
            self.state.tokens[slot, 0] = tok[0]
            self.state.pos[slot] = prompt.shape[1]
            self.state.active[slot] = True
            req.output.append(int(tok[0]))

    def step(self) -> None:
        """One scheduler tick: admit, decode, retire."""
        self._admit()
        self.state, next_tok = self._decode(self.params, self.state)
        toks = next_tok.cpu().numpy()
        pos = self.state.pos.cpu().numpy()
        for rid in self.slots_table.running():
            slot = self.slots_table.slot_of(rid)
            req = self._requests[rid]
            req.output.append(int(toks[slot]))
            done = len(req.output) >= req.max_new_tokens or (
                req.eos_id is not None and toks[slot] == req.eos_id
            ) or int(pos[slot]) >= self.max_seq - 1
            if done:
                self.slots_table.release(rid)
                del self._requests[rid]
                self.state.active[slot] = False

    def run(self, max_ticks: int = 1000) -> None:
        ticks = 0
        while (self.slots_table.queued_count
               or self.slots_table.active_count) and ticks < max_ticks:
            self.step()
            ticks += 1

    def stats(self) -> Dict[str, float]:
        """Queue-wait / residency / occupancy accounting (SlotTable)."""
        return self.slots_table.stats()


__all__ = ["EngineState", "Request", "ServeEngine", "check_servable"]
