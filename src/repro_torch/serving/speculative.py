"""Draft-model speculative decoding for the fused paged plane
(counterpart of the JAX package's ``serving/speculative.py``).

The engine's fused dispatch verifies K drafted tokens for free: a
decoding request whose next K tokens are guessed enters the step as a
short extend "chunk" of K+1 tokens ([pending, d1..dK] at its current
context position, against its own pages), sharing the single
``mixed_paged_spec`` dispatch with ordinary prefill chunks and
non-speculative decode slots. This module produces the guesses:

  * ``SpeculativeConfig`` — the knob bundle an ``EngineConfig`` carries
    (draft model config/params, K, pricing priors for the CostModel).
  * ``DraftWorker`` — a miniature paged serving plane for the draft
    model on the engine's device: its own ``PagedKVPool``
    (``("dr", request_id)`` tables, one per decoding request, never
    forked, so append/trim need no copy-on-write), its own page pool,
    and ONE propose call per step that catches the draft KV up to the
    target sequence (the chunk half of the draft's ``mixed_paged``) and
    then rolls K-1 bucketed paged decode steps. The reference runs the
    propose as one jitted dispatch; here it runs eagerly, and still
    counts as one draft dispatch.

On a tensor-parallel engine the draft's parameters and pool are sharded
over the engine's submesh by the same policies as the target's
(``serve_policy``, ``pool_pspec``), and its propose runs the same
sharded forwards.

Accept/trim protocol (greedy, token-exact vs the plain fused plane):
with ``a`` leading draft tokens accepted by the target, the request
commits d1..da plus the target's correction p_a, and the draft table
trims to ``pos + 1 + a`` valid tokens — rejected draft KV is freed
through the pool's normal ``trim``. The engine overwrites rejected
TARGET KV positionally on the next step, so the target pool needs no
trim at all.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..bridge import tree_to
from ..configs.base import ModelConfig
from ..launch import sharding as shard_lib
from ..models import zoo
from ..models.transformer import paged_servable
from .batch import bucket, lower_arrays
from .kv_cache import PagedKVPool

Pytree = Any


@dataclass
class SpeculativeConfig:
    """Speculation knobs carried by ``EngineConfig.speculative``.

    ``draft_params`` (a tree of tensors, e.g. bridged from the JAX
    package with ``bridge.tree_from_numpy``) are moved to the engine's
    device. Without them the draft gets random parameters from
    ``bridge.init_params`` with a ``torch.Generator`` seeded with
    ``draft_seed`` — the port's own draw, not the JAX package's
    ``PRNGKey(draft_seed)`` values. ``acceptance``/``draft_cost`` are
    PRICING PRIORS for the CostModel, not runtime behavior — the engine
    measures the realized acceptance rate into its stats."""
    draft_cfg: ModelConfig
    k: int = 4
    draft_params: Optional[Pytree] = None
    draft_seed: int = 0
    # priors consumed by CostModel.with_speculative at cluster wiring
    acceptance: float = 0.8
    draft_cost: float = 0.15


class DraftWorker:
    """The draft model's private paged serving plane.

    One per speculative engine; rebuilt wholesale by ``Engine.fail()``
    (fresh pool, fresh tables) exactly like the target plane. Tables are
    keyed ``("dr", request_id)`` and live from a request's first propose
    to its finish; a pool squeeze degrades the lane to plain decode for
    the step (propose returns no drafts for it) instead of evicting —
    the draft tier has no host tier and no cached nodes to reclaim."""

    def __init__(self, spec: SpeculativeConfig, econf, device="cuda",
                 mesh=None):
        self.spec = spec
        self.k = max(int(spec.k), 1)
        # same normalization the engine applies to the target config
        self.cfg = dataclasses.replace(spec.draft_cfg, sliding_window=0)
        if not paged_servable(self.cfg):
            raise ValueError(
                f"draft model {self.cfg.name} is not paged-servable — "
                "speculative decoding needs a paged draft plane")
        self.api = zoo.build(self.cfg)
        self.device = torch.device(device)
        self.params = (
            tree_to(spec.draft_params, self.device)
            if spec.draft_params is not None
            else self.api.init(torch.Generator(device=self.device)
                               .manual_seed(spec.draft_seed), self.device))
        self.plan = None
        if mesh is not None:
            self.params = shard_lib.shard_params(
                self.params, self.api.specs, mesh,
                shard_lib.serve_policy(mesh, self.api.n_bytes))
        ps = econf.page_size
        # mirror the target pool's sizing: the draft working set is
        # bounded by the same live sequences; the degrade path absorbs
        # the (rare) shortfall instead of evicting
        n_pages = (econf.device_capacity_tokens // ps
                   + 2 * econf.max_batch_requests + 1)
        self.pool = PagedKVPool(n_pages, ps)
        self._scratch_page = self.pool.reserve_page()   # page 0, pinned
        assert self._scratch_page == 0
        self._pages_per_req = -(-econf.max_context // ps)
        if mesh is not None:
            self.plan = self.api.shard_plan(mesh, n_pages, ps)
        self.pages = self.api.paged_cache_specs(n_pages, ps, self.device,
                                                self.plan)
        self.dispatches = 0      # propose calls (the reference's jits)
        self.decode_steps = 0    # decode_paged forwards inside them
        self.degraded = 0

    # ---- the propose call ---------------------------------------------

    def _propose_forward(self, ctoks, cstart, clen, cpt, kvec, kmax: int
                         ) -> torch.Tensor:
        """Catch-up + rollout. Chunk half: per-lane tokens [dlen, pos] of
        the TRUE sequence (everything the target committed that the draft
        KV lacks, including the pending next token) — its last-position
        prediction is d1. Then paged decode steps feed d_j at position
        base + j - 1 to produce d_{j+1}. Lanes whose budget ``kvec`` is
        exhausted (k_i <= j) are masked: a zeroed page-table row, pos and
        token route their reads AND writes to the scratch page 0. Steps
        past ``kmax`` (the largest budget, known on the host) would be
        all-masked and are skipped. Returns drafts [Lc, K] (masked
        entries 0, ignored host-side)."""
        Lc = ctoks.shape[0]
        dev = self.device
        zero_t = torch.zeros(1, dtype=torch.int32, device=dev)
        nxt, self.pages = self.api.mixed_paged(
            self.params, self.pages,
            {"chunk_tokens": ctoks, "chunk_start": cstart,
             "chunk_len": clen, "chunk_page_table": cpt,
             "dec_tokens": zero_t, "dec_pos": zero_t,
             "dec_page_table": torch.zeros((1, cpt.shape[1]),
                                           dtype=torch.int32, device=dev)},
            plan=self.plan)
        zero = torch.zeros_like(kvec)
        cur = nxt[:Lc]
        base = cstart + clen           # position d1 occupies when fed
        drafts = [torch.where(kvec > 0, cur, zero)]
        for j in range(1, self.k):
            if j >= kmax:
                drafts.append(zero)
                continue
            live = kvec > j            # lanes still needing d_{j+1}
            toks = torch.where(live, cur, zero)
            pos = torch.where(live, base + (j - 1), zero)
            pt = torch.where(live[:, None], cpt, torch.zeros_like(cpt))
            cur, self.pages = self.api.decode_paged(
                self.params, self.pages,
                {"tokens": toks, "pos": pos, "page_table": pt},
                plan=self.plan)
            self.decode_steps += 1
            drafts.append(torch.where(live, cur, zero))
        return torch.stack(drafts, dim=1)

    # ---- host-side lifecycle -------------------------------------------

    def propose(self, lanes: Sequence[Tuple[Any, int]]
                ) -> Dict[int, List[int]]:
        """Draft k_eff tokens for each (request, k_eff) lane.

        Returns {request_id: [d1..d_{k_eff}]}; a lane missing from the
        result degraded (draft pool squeeze) and must run as a plain
        decode slot this step. Bookkeeping per lane: the table is
        appended to exactly ``pos + k_eff`` tokens BEFORE the forward
        (catch-up chunk ends at pos, then k_eff - 1 decode feeds), so
        ``num_tokens`` always equals the tokens actually written."""
        staged = []
        for r, k_eff in lanes:
            rid = ("dr", r.request_id)
            full = list(r.tokens) + list(r.output_tokens)
            pos = len(full) - 1        # context position of the pending
            t = self.pool.tables.get(rid)     # token (output_tokens[-1])
            if t is None:
                t = self.pool.create(rid)
            dlen = t.num_tokens
            try:
                self.pool.append(rid, pos + k_eff - dlen)
            except MemoryError:
                self.pool.release(rid)
                self.degraded += 1
                continue
            staged.append((r, k_eff, full, pos, dlen))
        if not staged:
            return {}
        Lc = bucket(len(staged))
        Cb = bucket(max(pos + 1 - dlen
                         for _, _, _, pos, dlen in staged))
        ctoks = np.zeros((Lc, Cb), np.int32)
        cstart = np.zeros(Lc, np.int32)
        clen = np.zeros(Lc, np.int32)
        kvec = np.zeros(Lc, np.int32)
        cpt = np.zeros((Lc, self._pages_per_req), np.int32)
        for i, (r, k_eff, full, pos, dlen) in enumerate(staged):
            gap = pos + 1 - dlen
            ctoks[i, :gap] = full[dlen:pos + 1]
            cstart[i], clen[i], kvec[i] = dlen, gap, k_eff
            pages = self.pool.tables[("dr", r.request_id)].pages
            cpt[i, :len(pages)] = pages
        arrs = lower_arrays((ctoks, cstart, clen, cpt, kvec), self.device)
        drafts = self._propose_forward(*arrs, kmax=int(kvec.max()))
        drafts = drafts.cpu().numpy()
        self.dispatches += 1
        return {r.request_id: [int(x) for x in drafts[i, :k_eff]]
                for i, (r, k_eff, _, _, _) in enumerate(staged)}

    def commit(self, request_id: int, pos: int, accepted: int) -> None:
        """Trim the draft table to the verified prefix: positions
        [0, pos + accepted] hold committed tokens (catch-up through the
        pending token at ``pos``, then d1..d_accepted); everything past
        that is rejected junk and its pages free through the pool's
        refcounted trim. ``accepted == k_eff`` clamps without freeing
        (dK was proposed but never fed into the draft KV)."""
        rid = ("dr", request_id)
        if rid in self.pool.tables:
            self.pool.trim(rid, pos + 1 + accepted)

    def release(self, request_id: int) -> None:
        self.pool.release(("dr", request_id))
