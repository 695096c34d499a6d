"""Model zoo API of the port: ``build(cfg)`` -> a ``ModelAPI`` with the
dense and paged serving entry points (counterpart of the JAX package's
``models/zoo.py``). Decoder stacks of attention mixers with dense
(SwiGLU) FFNs are ported, with or without a sliding window; a windowed
stack has no paged entry points (None, as in the reference: the page
pool holds no ring buffer). Encoder-decoder, MoE and recurrent stacks
raise ``NotImplementedError``. Training (``loss``) is not ported.

Batch dicts hold int32 tensors on the model's device (``start``/``pos``
of the dense entries may also be ints):
  prefill:      {"tokens": [B, S]}
  decode:       {"tokens": [B], "pos": int | [B]}
  extend:       {"tokens": [B, C], "start": int | [B]}
  decode_paged: {"tokens": [B], "pos": [B], "page_table": [B, P]}
  extend_paged: {"tokens": [B, C], "start": [B], "page_table": [B, P]}
  mixed_paged:  {"chunk_tokens": [Lc, C], "chunk_start": [Lc],
                 "chunk_len": [Lc], "chunk_page_table": [Lc, P],
                 "dec_tokens": [Ld], "dec_pos": [Ld],
                 "dec_page_table": [Ld, P]}
  mixed_paged_spec: the mixed_paged batch.
prefill returns (nxt, cache): greedy next tokens (int32) and a new
cache (``cache_specs`` layout, windowed stacks as ring buffers). The
others return (nxt, cache_or_pages), the cache or pool they were given,
updated in place; mixed_paged_spec returns (nxt, chunk_pred, pages),
chunk_pred [Lc, C] the greedy token after every chunk position.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import bridge
from ..configs.base import ModelConfig
from . import layers as L
from . import transformer as T
from .common import rms_norm, top1_logits

Pytree = Any
Entry = Callable[..., Tuple]


@dataclass
class ModelAPI:
    cfg: ModelConfig
    prefill: Entry
    decode: Entry
    extend: Entry
    # (batch, seq) -> {"p{j}": {"k","v": CacheSpec}}
    cache_specs: Callable[[int, int], Pytree]
    # the paged entry points: None when the stack is not paged-servable
    # (transformer.paged_servable); paged_cache_specs(n_pages, page_size,
    # device) allocates the pool
    decode_paged: Optional[Entry] = None
    extend_paged: Optional[Entry] = None
    paged_cache_specs: Optional[Callable[..., Pytree]] = None
    mixed_paged: Optional[Entry] = None
    mixed_paged_spec: Optional[Entry] = None

    def init(self, generator: torch.Generator, device) -> Pytree:
        return bridge.init_params(self.cfg, generator, device)


def _build_decoder(cfg: ModelConfig) -> ModelAPI:
    def final(params, h):
        h = rms_norm(h, params["embed"]["final_norm"], cfg.norm_eps)
        return top1_logits(h, L.head_matrix(params["embed"], cfg))

    def embed(params, tokens):
        return L.embed_tokens(params["embed"], cfg, tokens)

    def prefill(params, batch: Dict, *, attn_impl: str = "auto"):
        h, cache = T.forward_full(params["stack"], cfg,
                                  embed(params, batch["tokens"]),
                                  want_cache=True, attn_impl=attn_impl)
        return final(params, h[:, -1]), cache

    def decode(params, cache, batch: Dict):
        h, cache = T.forward_step(params["stack"], cfg,
                                  embed(params, batch["tokens"]), cache,
                                  batch["pos"])
        return final(params, h), cache

    def extend(params, cache, batch: Dict):
        h, cache = T.forward_extend(params["stack"], cfg,
                                    embed(params, batch["tokens"]), cache,
                                    batch["start"])
        return final(params, h[:, -1]), cache

    def decode_paged(params, pages, batch: Dict):
        h, pages = T.forward_step_paged(params["stack"], cfg,
                                        embed(params, batch["tokens"]),
                                        pages, batch["page_table"],
                                        batch["pos"])
        return final(params, h), pages

    def extend_paged(params, pages, batch: Dict):
        h, pages = T.forward_extend_paged(params["stack"], cfg,
                                          embed(params, batch["tokens"]),
                                          pages, batch["page_table"],
                                          batch["start"])
        return final(params, h[:, -1]), pages

    def mixed_hidden(params, pages, batch: Dict):
        """The fused forward; h packs chunk lanes' last-valid-token
        states first, then the decode lanes (the LM head runs on O(lanes)
        gathered hidden states)."""
        hc, hd, pages = T.forward_mixed_paged(
            params["stack"], cfg, embed(params, batch["chunk_tokens"]),
            embed(params, batch["dec_tokens"]), pages,
            batch["chunk_page_table"], batch["chunk_start"],
            batch["chunk_len"], batch["dec_page_table"], batch["dec_pos"])
        last = torch.clamp(batch["chunk_len"] - 1, min=0).long()
        rows = torch.arange(hc.shape[0], device=hc.device)
        return hc, torch.cat([hc[rows, last], hd], dim=0), pages

    def mixed_paged(params, pages, batch: Dict):
        _, h, pages = mixed_hidden(params, pages, batch)
        return final(params, h), pages

    def mixed_paged_spec(params, pages, batch: Dict):
        """``mixed_paged`` plus the verification head: chunk_pred
        [Lc, C], the greedy prediction after EVERY chunk position, with
        the same norm and head as the lane predictions (so
        chunk_pred[i, last_i] == nxt[i])."""
        hc, h, pages = mixed_hidden(params, pages, batch)
        return final(params, h), final(params, hc), pages

    paged = T.paged_servable(cfg)
    return ModelAPI(
        cfg, prefill, decode, extend,
        lambda b, s: T.cache_specs(cfg, b, s),
        decode_paged=decode_paged if paged else None,
        extend_paged=extend_paged if paged else None,
        paged_cache_specs=((lambda n, ps, device:
                            T.paged_cache_specs(cfg, n, ps, device))
                           if paged else None),
        mixed_paged=mixed_paged if paged else None,
        mixed_paged_spec=mixed_paged_spec if paged else None)


def build(cfg: ModelConfig) -> ModelAPI:
    if cfg.encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder stacks are "
                                  "not ported yet")
    if cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: MoE FFNs are not ported yet")
    if any(p.mixer != "attn" or p.cross for p in T.layer_plan(cfg)):
        raise NotImplementedError(f"{cfg.name}: recurrent and cross-"
                                  "attention positions are not ported yet")
    return _build_decoder(cfg)
