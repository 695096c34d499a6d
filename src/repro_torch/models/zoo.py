"""Model zoo API of the port: ``build(cfg)`` -> a ``ModelAPI`` with the
paged serving entry points (counterpart of the JAX package's
``models/zoo.py``). Only paged-servable decoders with dense (SwiGLU)
FFNs are ported so far; anything else raises ``NotImplementedError``.

Batch dicts hold int32 tensors on the model's device:
  decode_paged: {"tokens": [B], "pos": [B], "page_table": [B, P]}
  extend_paged: {"tokens": [B, C], "start": [B], "page_table": [B, P]}
  mixed_paged:  {"chunk_tokens": [Lc, C], "chunk_start": [Lc],
                 "chunk_len": [Lc], "chunk_page_table": [Lc, P],
                 "dec_tokens": [Ld], "dec_pos": [Ld],
                 "dec_page_table": [Ld, P]}
  mixed_paged_spec: the mixed_paged batch.
Each returns (nxt, pages): greedy next tokens (int32) and the pool,
which it updated in place; mixed_paged_spec returns (nxt, chunk_pred,
pages), chunk_pred [Lc, C] the greedy token after every chunk position.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from .. import bridge
from ..configs.base import ModelConfig
from . import layers as L
from . import transformer as T
from .common import rms_norm, top1_logits

Pytree = Any


@dataclass
class ModelAPI:
    cfg: ModelConfig

    def init(self, generator: torch.Generator, device) -> Pytree:
        return bridge.init_params(self.cfg, generator, device)

    def paged_cache_specs(self, n_pages: int, page_size: int,
                          device) -> Pytree:
        return T.paged_cache_specs(self.cfg, n_pages, page_size, device)

    def _final(self, params, h):
        cfg = self.cfg
        h = rms_norm(h, params["embed"]["final_norm"], cfg.norm_eps)
        return top1_logits(h, L.head_matrix(params["embed"], cfg))

    def decode_paged(self, params, pages, batch: Dict):
        cfg = self.cfg
        x = L.embed_tokens(params["embed"], cfg, batch["tokens"])
        h, pages = T.forward_step_paged(params["stack"], cfg, x, pages,
                                        batch["page_table"], batch["pos"])
        return self._final(params, h), pages

    def extend_paged(self, params, pages, batch: Dict):
        cfg = self.cfg
        x = L.embed_tokens(params["embed"], cfg, batch["tokens"])
        h, pages = T.forward_extend_paged(params["stack"], cfg, x, pages,
                                          batch["page_table"],
                                          batch["start"])
        return self._final(params, h[:, -1]), pages

    def mixed_paged(self, params, pages, batch: Dict):
        """nxt packs chunk lanes first (each lane's last-valid-token
        prediction), then decode lanes; the LM head runs on O(lanes)
        gathered hidden states."""
        cfg = self.cfg
        xc = L.embed_tokens(params["embed"], cfg, batch["chunk_tokens"])
        xd = L.embed_tokens(params["embed"], cfg, batch["dec_tokens"])
        hc, hd, pages = T.forward_mixed_paged(
            params["stack"], cfg, xc, xd, pages,
            batch["chunk_page_table"], batch["chunk_start"],
            batch["chunk_len"], batch["dec_page_table"], batch["dec_pos"])
        last = torch.clamp(batch["chunk_len"] - 1, min=0).long()
        rows = torch.arange(hc.shape[0], device=hc.device)
        h = torch.cat([hc[rows, last], hd], dim=0)
        return self._final(params, h), pages

    def mixed_paged_spec(self, params, pages, batch: Dict):
        """``mixed_paged`` plus the verification head: chunk_pred
        [Lc, C], the greedy prediction after EVERY chunk position, with
        the same norm and head as the lane predictions (so
        chunk_pred[i, last_i] == nxt[i]). Returns (nxt, chunk_pred,
        pages)."""
        cfg = self.cfg
        xc = L.embed_tokens(params["embed"], cfg, batch["chunk_tokens"])
        xd = L.embed_tokens(params["embed"], cfg, batch["dec_tokens"])
        hc, hd, pages = T.forward_mixed_paged(
            params["stack"], cfg, xc, xd, pages,
            batch["chunk_page_table"], batch["chunk_start"],
            batch["chunk_len"], batch["dec_page_table"], batch["dec_pos"])
        last = torch.clamp(batch["chunk_len"] - 1, min=0).long()
        rows = torch.arange(hc.shape[0], device=hc.device)
        nxt = self._final(params, torch.cat([hc[rows, last], hd], dim=0))
        chunk_pred = self._final(params, hc)
        return nxt, chunk_pred, pages


def build(cfg: ModelConfig) -> ModelAPI:
    if cfg.encoder_decoder or not T.paged_servable(cfg):
        raise NotImplementedError(f"{cfg.name}: only paged-servable decoder "
                                  "stacks are ported")
    if cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: MoE FFNs are not ported yet")
    return ModelAPI(cfg)
