"""Model zoo API of the port: ``build(cfg)`` -> a ``ModelAPI`` with the
dense and paged serving entry points (counterpart of the JAX package's
``models/zoo.py``) for every config of the zoo. Decoder stacks (dense,
MoE, sliding-window, RWKV, the mamba / attention hybrid, the VLM with
cross-attention) have prefill, decode and extend; only attention-only
stacks without a window have the paged entry points (None otherwise, as
in the reference: the page pool holds no ring buffer and no recurrent
state). The encoder-decoder (whisper) has loss, prefill and decode only.
``loss`` is the training objective of every family (``train/``).

Batch dicts hold int32 tensors on the model's device (``start``/``pos``
of the dense entries may also be ints); "vision" [B, n_vision_tokens, d]
(VLM) and "frames" [B, S_enc, d] (encoder-decoder) are float tensors in
the model's dtype:
  loss:         {"tokens": [B, S], "labels": [B, S]} (+ "loss_mask"
                [B, S], + "vision" | "frames"); returns the float32 mean
                next-token NLL over the unmasked positions
                (``common.chunked_ce_loss``), differentiable in params
  prefill:      {"tokens": [B, S]} (+ "vision" | "frames")
  decode:       {"tokens": [B], "pos": int | [B]}
  extend:       {"tokens": [B, C], "start": int | [B]} (+ "vision": seeds
                the cross KV before the chunk, ``seed_cross_cache``)
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

Tensor-parallel instances: ``ModelAPI.shard_plan(mesh, n_pages,
page_size)`` lays the model and its pool over a serve submesh
(``launch/mesh.py``). Given that plan (``plan=``), the paged entry
points take ``params`` and ``pages`` as one tree per shard
(``launch/sharding.py::shard_params``, ``paged_cache_specs(...,
plan=plan)``) and the batch tensors on shard 0's device (each shard
reads them there or gets a copy); the results lie on shard 0's device.
The step still makes one call, which loops over the shards inside.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import cached_property
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import bridge
from ..configs.base import ModelConfig
from ..launch import mesh as M
from . import layers as L
from . import transformer as T
from .common import chunked_ce_loss, rms_norm, top1_logits

Pytree = Any
Entry = Callable[..., Tuple]


@dataclass
class ModelAPI:
    cfg: ModelConfig
    # loss(params, batch, *, remat=True, attn_impl="auto") -> scalar
    loss: Entry
    prefill: Entry
    decode: Entry
    # None for an encoder-decoder stack, as in the reference
    extend: Optional[Entry]
    # (batch, seq) -> {"p{j}": {leaf: CacheSpec}}
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

    @property
    def specs(self) -> Pytree:
        """Shapes, init kinds and logical axes of every leaf."""
        return bridge.param_specs(self.cfg)

    def abstract(self, device="meta") -> Pytree:
        """The parameters as empty tensors (meta by default: shapes and
        dtypes only), the reference's ``abstract()``."""
        return bridge.abstract_params(self.cfg, device)

    def axes(self) -> Pytree:
        return bridge.logical_axes(self.cfg)

    @cached_property
    def n_params(self) -> int:
        return bridge.param_count(self.cfg)

    @property
    def n_bytes(self) -> int:
        return bridge.param_bytes(self.cfg)

    @property
    def n_active_params(self) -> int:
        """Parameters a token touches: leaves with an "experts" axis
        scaled by K / E (the JAX package's ``n_active_params``)."""
        cfg = self.cfg
        return _count(self.specs, lambda s: (
            cfg.experts_per_token / cfg.n_experts
            if cfg.n_experts and "experts" in s.axes else 1.0))

    def shard_plan(self, mesh, n_pages: int, page_size: int):
        """The layout of this model and a pool of n_pages x page_size on
        ``mesh`` under ``serve_policy`` (``launch/sharding.py``)."""
        from ..launch.sharding import shard_plan
        return shard_plan(self.cfg, mesh, n_pages, page_size)


def _count(tree, weight) -> int:
    """sum over the leaves of numel x weight(spec), as an int."""
    total = 0.0

    def walk(t):
        nonlocal total
        if isinstance(t, bridge.Spec):
            n = 1
            for d in t.shape:
                n *= d
            total += n * weight(t)
            return
        for v in t.values():
            walk(v)

    walk(tree)
    return int(total)


def _build_decoder(cfg: ModelConfig) -> ModelAPI:
    def final(params, h):
        h = rms_norm(h, params["embed"]["final_norm"], cfg.norm_eps)
        return top1_logits(h, L.head_matrix(params["embed"], cfg))

    def final_tp(params, hs, plan):
        es = [p["embed"] for p in params]
        hs = [rms_norm(h, e["final_norm"], cfg.norm_eps)
              for h, e in zip(hs, es)]
        return L.top1_logits_tp(hs, es, cfg, plan)

    def embed(params, tokens):
        return L.embed_tokens(params["embed"], cfg, tokens)

    def rep(plan, batch: Dict) -> Dict:
        """Every batch tensor on every shard (read-only)."""
        return {k: M.replicate(v, plan.mesh) for k, v in batch.items()}

    def embed_tp(params, plan, tokens):
        return L.embed_tokens_tp([p["embed"] for p in params], cfg, tokens,
                                 plan)

    def stacks(params):
        return [p["stack"] for p in params]

    def loss(params, batch: Dict, *, remat: bool = True,
             attn_impl: str = "auto"):
        """The mean next-token NLL of batch["labels"] (masked by
        "loss_mask" when given); "vision" is the cross-attention
        source of a VLM."""
        h, _ = T.forward_full(params["stack"], cfg,
                              embed(params, batch["tokens"]),
                              kv_src=batch.get("vision"), remat=remat,
                              attn_impl=attn_impl)
        h = rms_norm(h, params["embed"]["final_norm"], cfg.norm_eps)
        return chunked_ce_loss(h, L.head_matrix(params["embed"], cfg),
                               batch["labels"], batch.get("loss_mask"))

    def prefill(params, batch: Dict, *, attn_impl: str = "auto"):
        h, cache = T.forward_full(params["stack"], cfg,
                                  embed(params, batch["tokens"]),
                                  kv_src=batch.get("vision"),
                                  want_cache=True, attn_impl=attn_impl)
        return final(params, h[:, -1]), cache

    def decode(params, cache, batch: Dict):
        h, cache = T.forward_step(params["stack"], cfg,
                                  embed(params, batch["tokens"]), cache,
                                  batch["pos"])
        return final(params, h), cache

    def extend(params, cache, batch: Dict):
        if "vision" in batch:       # a VLM's admission: cross KV once
            cache = T.seed_cross_cache(params["stack"], cfg,
                                       batch["vision"], cache)
        h, cache = T.forward_extend(params["stack"], cfg,
                                    embed(params, batch["tokens"]), cache,
                                    batch["start"])
        return final(params, h[:, -1]), cache

    def decode_paged(params, pages, batch: Dict, plan=None):
        if plan is not None:
            b = rep(plan, batch)
            h, pages = T.forward_step_paged(
                stacks(params), cfg, embed_tp(params, plan, b["tokens"]),
                pages, b["page_table"], b["pos"], plan=plan)
            return final_tp(params, h, plan), pages
        h, pages = T.forward_step_paged(params["stack"], cfg,
                                        embed(params, batch["tokens"]),
                                        pages, batch["page_table"],
                                        batch["pos"])
        return final(params, h), pages

    def extend_paged(params, pages, batch: Dict, plan=None):
        if plan is not None:
            b = rep(plan, batch)
            h, pages = T.forward_extend_paged(
                stacks(params), cfg, embed_tp(params, plan, b["tokens"]),
                pages, b["page_table"], b["start"], plan=plan)
            return final_tp(params, [x[:, -1] for x in h], plan), pages
        h, pages = T.forward_extend_paged(params["stack"], cfg,
                                          embed(params, batch["tokens"]),
                                          pages, batch["page_table"],
                                          batch["start"])
        return final(params, h[:, -1]), pages

    def lanes(hc, hd, chunk_len):
        """Chunk lanes' last-valid-token states, then the decode lanes."""
        last = torch.clamp(chunk_len - 1, min=0).long()
        rows = torch.arange(hc.shape[0], device=hc.device)
        return torch.cat([hc[rows, last], hd], dim=0)

    def mixed_hidden(params, pages, batch: Dict, plan=None):
        """The fused forward; h packs chunk lanes' last-valid-token
        states first, then the decode lanes (the LM head runs on O(lanes)
        gathered hidden states). Per-shard lists with a ``plan``."""
        if plan is not None:
            b = rep(plan, batch)
            hc, hd, pages = T.forward_mixed_paged(
                stacks(params), cfg, embed_tp(params, plan,
                                              b["chunk_tokens"]),
                embed_tp(params, plan, b["dec_tokens"]), pages,
                b["chunk_page_table"], b["chunk_start"], b["chunk_len"],
                b["dec_page_table"], b["dec_pos"], plan=plan)
            return hc, [lanes(c, d, n) for c, d, n in
                        zip(hc, hd, b["chunk_len"])], pages
        hc, hd, pages = T.forward_mixed_paged(
            params["stack"], cfg, embed(params, batch["chunk_tokens"]),
            embed(params, batch["dec_tokens"]), pages,
            batch["chunk_page_table"], batch["chunk_start"],
            batch["chunk_len"], batch["dec_page_table"], batch["dec_pos"])
        return hc, lanes(hc, hd, batch["chunk_len"]), pages

    def head(params, h, plan):
        return final(params, h) if plan is None else final_tp(params, h,
                                                              plan)

    def mixed_paged(params, pages, batch: Dict, plan=None):
        _, h, pages = mixed_hidden(params, pages, batch, plan)
        return head(params, h, plan), pages

    def mixed_paged_spec(params, pages, batch: Dict, plan=None):
        """``mixed_paged`` plus the verification head: chunk_pred
        [Lc, C], the greedy prediction after EVERY chunk position, with
        the same norm and head as the lane predictions (so
        chunk_pred[i, last_i] == nxt[i])."""
        hc, h, pages = mixed_hidden(params, pages, batch, plan)
        return head(params, h, plan), head(params, hc, plan), pages

    paged = T.paged_servable(cfg)
    return ModelAPI(
        cfg, loss, prefill, decode, extend,
        lambda b, s: T.cache_specs(cfg, b, s),
        decode_paged=decode_paged if paged else None,
        extend_paged=extend_paged if paged else None,
        paged_cache_specs=((lambda n, ps, device, plan=None:
                            T.paged_cache_specs(cfg, n, ps, device, plan))
                           if paged else None),
        mixed_paged=mixed_paged if paged else None,
        mixed_paged_spec=mixed_paged_spec if paged else None)


def encdec_configs(cfg: ModelConfig) -> Tuple[ModelConfig, ModelConfig]:
    """The encoder's config (a plain non-causal dense stack of
    ``n_encoder_layers``) and the decoder's (cross-attention on every
    layer) of an encoder-decoder config."""
    enc = dataclasses.replace(cfg, encoder_decoder=False,
                              n_layers=cfg.n_encoder_layers,
                              cross_attn_period=0)
    dec = dataclasses.replace(cfg, encoder_decoder=False,
                              cross_attn_period=1, cross_attn_offset=0)
    return enc, dec


def _build_encdec(cfg: ModelConfig) -> ModelAPI:
    """Whisper: frames arrive embedded ([B, S_enc, d]); the encoder runs
    them once at prefill (and in the loss), and every decoder layer
    cross-attends its states. No chunk extension and no paged entries
    (None, as in the reference)."""
    enc_cfg, dec_cfg = encdec_configs(cfg)

    def final(params, h):
        h = rms_norm(h, params["embed"]["final_norm"], cfg.norm_eps)
        return top1_logits(h, L.head_matrix(params["embed"], cfg))

    def encode(params, frames, attn_impl="auto"):
        h, _ = T.forward_full(params["encoder"], enc_cfg, frames,
                              causal=False, attn_impl=attn_impl)
        return rms_norm(h, params["enc_norm"], cfg.norm_eps)

    def loss(params, batch: Dict, *, remat: bool = True,
             attn_impl: str = "auto"):
        """The decoder's mean next-token NLL over the encoded "frames"
        (the encoder without remat, the decoder with it, as the
        reference)."""
        enc = encode(params, batch["frames"], attn_impl)
        x = L.embed_tokens(params["embed"], cfg, batch["tokens"])
        h, _ = T.forward_full(params["decoder"], dec_cfg, x, kv_src=enc,
                              remat=remat, attn_impl=attn_impl)
        h = rms_norm(h, params["embed"]["final_norm"], cfg.norm_eps)
        return chunked_ce_loss(h, L.head_matrix(params["embed"], cfg),
                               batch["labels"], batch.get("loss_mask"))

    def prefill(params, batch: Dict, *, attn_impl: str = "auto"):
        """Encode the frames and prefill the decoder prompt; the self-KV
        is padded to max_target_len so decode steps can extend it."""
        enc = encode(params, batch["frames"], attn_impl)
        x = L.embed_tokens(params["embed"], cfg, batch["tokens"])
        h, cache = T.forward_full(params["decoder"], dec_cfg, x, kv_src=enc,
                                  want_cache=True, attn_impl=attn_impl)
        pad = cfg.max_target_len - batch["tokens"].shape[1]
        if pad > 0:
            cache = {pj: {n: (F.pad(a, (0, 0, 0, 0, 0, pad))
                              if n in ("k", "v") else a)
                          for n, a in c.items()}
                     for pj, c in cache.items()}
        return final(params, h[:, -1]), cache

    def decode(params, cache, batch: Dict):
        x = L.embed_tokens(params["embed"], cfg, batch["tokens"])
        h, cache = T.forward_step(params["decoder"], dec_cfg, x, cache,
                                  batch["pos"])
        return final(params, h), cache

    def cache_specs(batch: int, seq: int) -> Pytree:
        """``seq`` is the ENCODER length; the decoder's self-KV holds
        max_target_len positions."""
        out = {}
        for pj, c in T.cache_specs(dec_cfg, batch,
                                   cfg.max_target_len).items():
            c = dict(c)
            for n in ("ck", "cv"):
                c[n] = T.CacheSpec((c[n].shape[0], batch, seq,
                                    cfg.n_kv_heads, cfg.head_dim),
                                   c[n].dtype)
            out[pj] = c
        return out

    return ModelAPI(cfg, loss, prefill, decode, None, cache_specs)


def build(cfg: ModelConfig) -> ModelAPI:
    return _build_encdec(cfg) if cfg.encoder_decoder else _build_decoder(cfg)
