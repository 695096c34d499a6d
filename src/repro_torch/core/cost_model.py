"""Prefill / decode time cost model — Preble Appendix B, for one H100.

The paper fits per-GPU-type linear regressions ``prefill_time(tokens)`` and
``decode_time(tokens)`` from offline profiling and shows both are linear in
token count (their Figures 9/10).  We keep the same *shape* of model but
derive default coefficients analytically from the target hardware roofline
(NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3), and
allow calibration from measured samples (``fit``) exactly like the paper's
offline profiling.

prefill is compute-bound:   t ≈ 2 * P * tokens / peak_flops   (P = params)
decode is memory-bound:     t ≈ (P_bytes + kv_bytes(ctx)) / hbm_bw  per token

Both reduce to  t = a * tokens + b  for a fixed model/instance — the form E2
consumes (PREFILLTIME / DECODETIME in Algorithm 2).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

# NVIDIA H100 SXM per-card constants. These are NVIDIA's data-sheet
# figures, not measurements of this code; calibrate with ``fit`` from
# measured samples.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 dense tensor cores
HBM_BW = 3.35e12                  # B/s HBM3
ICI_BW_PER_LINK = 450e9           # B/s NVLink 4, each way, card to card
HOST_BW = 64e9                    # B/s PCIe Gen5 x16, each way
DCN_BW = 25e9                     # B/s host<->host datacenter network
                                  # (200 Gb/s NIC per serving host)


@dataclass
class HardwareSpec:
    name: str = "h100-sxm"
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    ici_bw: float = ICI_BW_PER_LINK
    host_bw: float = HOST_BW        # KV offload restore bandwidth per chip
    dcn_bw: float = DCN_BW          # host->host KV migration bandwidth
                                    # (per instance — NIC, not per chip)
    chips_per_instance: int = 1     # TP degree of one model instance
    mfu_prefill: float = 0.55       # achievable fraction of peak in prefill
    mbu_decode: float = 0.70        # achievable fraction of HBM bw in decode
    dma_eff: float = 0.80           # achievable fraction of host_bw
    dcn_eff: float = 0.70           # achievable fraction of dcn_bw


@dataclass
class ModelSpec:
    """Just enough model shape for the cost model."""
    name: str
    n_params: float                 # total parameters
    n_active_params: float          # active per token (MoE: top-k slice)
    n_layers: int
    d_model: int
    n_kv_heads: int
    head_dim: int
    bytes_per_param: float = 2.0    # bf16 weights
    kv_bytes_per_token: float = field(init=False)

    def __post_init__(self):
        # K + V, bf16
        self.kv_bytes_per_token = (
            2 * self.n_layers * self.n_kv_heads * self.head_dim * 2.0
        )


def expected_tokens_per_step(acceptance: float, k: int) -> float:
    """Expected committed tokens per target verify dispatch when a
    draft model proposes ``k`` tokens accepted i.i.d. at rate
    ``acceptance``: E = sum_{i=0..k} a^i = (1 - a^(k+1)) / (1 - a),
    i.e. the accepted prefix plus the free correction token. Bounded in
    [1, k + 1]; equals 1 at a = 0 (every step still commits the
    correction) and k + 1 at a = 1."""
    if k <= 0:
        return 1.0
    a = min(max(acceptance, 0.0), 1.0)
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


@dataclass
class CostModel:
    """Linear prefill/decode regressions, per (model, hardware) pair.

    ``prefill_time(n)``  — seconds to prefill n *missed* prompt tokens.
    ``decode_time(n)``   — seconds to generate n tokens at avg context ctx.
    """

    hw: HardwareSpec
    model: ModelSpec
    # regression coefficients: time = a * tokens + b  (seconds)
    prefill_a: float = field(init=False)
    prefill_b: float = 0.002        # launch/schedule overhead per batch
    decode_a: float = field(init=False)
    decode_b: float = 0.0
    # host->device KV restore (hierarchical tiering): bandwidth-bound
    restore_a: float = field(init=False)
    restore_b: float = 0.0005       # DMA launch / page-table fixup overhead
    # host->host KV migration over DCN (tier-to-tier prefix migration):
    # a demoted span ships to another instance's host tier, where the
    # normal restore path materializes it on device
    migrate_a: float = field(init=False)
    migrate_b: float = 0.002        # RPC setup / span index exchange
    avg_context: float = 2048.0     # used for the KV-read term of decode
    # decode runs continuously batched: the weight read amortizes over
    # the co-resident decode tokens (matches the paper's profiled decode
    # regressions, which are measured under serving batch sizes)
    avg_decode_batch: float = 32.0
    # ---- speculative decoding (DESIGN.md §14) ----
    # spec_k = 0 prices plain one-token-per-step decode (byte-identical
    # to the pre-spec model). spec_k > 0: each target dispatch verifies
    # K drafted tokens and commits E = (1 - a^(K+1)) / (1 - a) expected
    # tokens (a = spec_acceptance), while the draft model adds
    # spec_draft_cost x decode_a per drafted token. E2 and the
    # simulator consume decode_time/batch_time unchanged — a spec-aware
    # instance simply carries a cheaper (or, at low acceptance, more
    # expensive) per-token decode coefficient.
    spec_k: int = 0
    spec_acceptance: float = 0.0
    spec_draft_cost: float = 0.15

    def __post_init__(self):
        self._derive()

    def _derive(self) -> None:
        chips = self.hw.chips_per_instance
        flops_per_token = 2.0 * self.model.n_active_params
        self.prefill_a = flops_per_token / (
            self.hw.peak_flops * self.hw.mfu_prefill * chips
        )
        weight_bytes = (self.model.n_active_params * self.model.bytes_per_param
                        / max(self.avg_decode_batch, 1.0))
        kv_read = self.model.kv_bytes_per_token * self.avg_context
        self.decode_a = (weight_bytes + kv_read) / (
            self.hw.hbm_bw * self.hw.mbu_decode * chips
        )
        # each chip restores its own KV shard over its own host link
        self.restore_a = self.model.kv_bytes_per_token / (
            self.hw.host_bw * self.hw.dma_eff * chips
        )
        # migration crosses ONE host NIC pair regardless of TP degree
        # (host RAM is per host; the restore on the target then fans the
        # span back out over the chips' host links)
        self.migrate_a = self.model.kv_bytes_per_token / (
            self.hw.dcn_bw * self.hw.dcn_eff
        )

    # ---- the functions Algorithm 2 calls ------------------------------------

    def prefill_time(self, missed_tokens: float) -> float:
        if missed_tokens <= 0:
            return 0.0
        return self.prefill_a * missed_tokens + self.prefill_b

    def spec_factor(self) -> float:
        """Per-committed-token decode cost multiplier under speculative
        decoding: (1 + K * draft_cost) target+draft work per step,
        amortized over the expected committed tokens E(a, K). 1.0 when
        speculation is off (spec_k == 0)."""
        if self.spec_k <= 0:
            return 1.0
        e = expected_tokens_per_step(self.spec_acceptance, self.spec_k)
        return (1.0 + self.spec_k * self.spec_draft_cost) / e

    def decode_time(self, out_tokens: float) -> float:
        if out_tokens <= 0:
            return 0.0
        return self.decode_a * self.spec_factor() * out_tokens \
            + self.decode_b

    def restore_time(self, host_tokens: float) -> float:
        """Seconds to restore ``host_tokens`` of demoted KV host->device
        (tier-aware E2: a host-cached prefix is neither free nor a full
        recompute — it costs one bandwidth-bound DMA)."""
        if host_tokens <= 0:
            return 0.0
        return self.restore_a * host_tokens + self.restore_b

    def migrate_time(self, tokens: float) -> float:
        """Seconds to ship ``tokens`` of demoted KV host->host over DCN
        (tier-to-tier migration). The migrated span still pays
        restore_time on the target when a request materializes it on
        device — E2 prices migration as migrate + restore vs recompute."""
        if tokens <= 0:
            return 0.0
        return self.migrate_a * tokens + self.migrate_b

    def prefetch_time(self, restore_tokens: float,
                      migrate_tokens: float = 0.0) -> float:
        """Seconds of DMA a speculative-restore prefetch spends OFF the
        TTFT critical path: the host->device restore of every
        prefetched token plus the host->host DCN leg for the part that
        arrives via migration (DESIGN.md §10). E2 prices a
        PrefetchPlan with this; the simulator uses the same number as
        the prefetch pipeline's completion latency — schedule-time
        prefetch hides exactly this much restore work behind queue
        wait."""
        return (self.restore_time(restore_tokens + migrate_tokens)
                + self.migrate_time(migrate_tokens))

    # ---- iteration-level batch time (simulator / engine pacing) -------------

    def batch_time(self, prefill_tokens: float, n_decode: int,
                   avg_ctx: Optional[float] = None) -> float:
        """One continuous-batching iteration: a chunked-prefill of
        ``prefill_tokens`` piggybacking ``n_decode`` decode tokens
        (Sarathi-style). When prefill is present the weight read is
        covered by the compute-bound prefill; decodes then only add
        their KV reads. A pure-decode batch pays one weight pass +
        per-request KV reads."""
        if prefill_tokens <= 0 and n_decode <= 0:
            return 0.0
        t = self.prefill_b
        bw = self.hw.hbm_bw * self.hw.mbu_decode * self.hw.chips_per_instance
        if prefill_tokens > 0:
            t += self.prefill_a * prefill_tokens
        elif n_decode > 0:
            t += (self.model.n_active_params * self.model.bytes_per_param) / bw
        if n_decode > 0:
            ctx = avg_ctx if avg_ctx is not None else self.avg_context
            # speculative decode: the same per-iteration KV read now
            # commits E expected tokens (and pays the draft overhead),
            # so the per-committed-token read scales by spec_factor
            t += (n_decode * self.model.kv_bytes_per_token * ctx / bw
                  * self.spec_factor())
        return t

    def with_chips(self, chips: int) -> "CostModel":
        """Re-derive this cost model for a ``chips``-way TP submesh of
        the same hardware (mesh-of-meshes: a heterogeneous cluster holds
        1-chip and 4-chip instances side by side, and E2 must price each
        against its own aggregate HBM/compute). Calibrated coefficients
        (``fit``) do not carry over — they were measured at the old TP
        degree."""
        import dataclasses as _dc
        hw = _dc.replace(self.hw, chips_per_instance=max(chips, 1))
        return CostModel(hw=hw, model=self.model,
                         prefill_b=self.prefill_b, decode_b=self.decode_b,
                         restore_b=self.restore_b, migrate_b=self.migrate_b,
                         avg_context=self.avg_context,
                         avg_decode_batch=self.avg_decode_batch,
                         spec_k=self.spec_k,
                         spec_acceptance=self.spec_acceptance,
                         spec_draft_cost=self.spec_draft_cost)

    def with_speculative(self, k: int, acceptance: float,
                         draft_cost: float = 0.15) -> "CostModel":
        """Acceptance-aware decode pricing for a speculative-decoding
        instance (draft proposes ``k`` tokens/step accepted at rate
        ``acceptance``; the draft model costs ``draft_cost`` of a
        target decode step per drafted token). E2's load_cost and the
        simulator price decode through the returned model so spec-on
        instances are not mis-priced against spec-off ones."""
        import dataclasses as _dc
        return _dc.replace(self, spec_k=max(int(k), 0),
                           spec_acceptance=min(max(acceptance, 0.0), 1.0),
                           spec_draft_cost=max(draft_cost, 0.0))

    # ---- calibration (paper: offline profiling regression) ------------------

    def fit(self, prefill_samples: Sequence[Tuple[float, float]],
            decode_samples: Sequence[Tuple[float, float]]) -> None:
        """Least-squares fit of (tokens, seconds) samples, like the paper's
        offline profiling. Overrides the analytic defaults."""
        if prefill_samples:
            self.prefill_a, self.prefill_b = _lsq(prefill_samples)
        if decode_samples:
            self.decode_a, self.decode_b = _lsq(decode_samples)


def _lsq(samples: Sequence[Tuple[float, float]]) -> Tuple[float, float]:
    n = len(samples)
    if n == 1:
        x, y = samples[0]
        return (y / x if x else 0.0), 0.0
    sx = sum(s[0] for s in samples)
    sy = sum(s[1] for s in samples)
    sxx = sum(s[0] * s[0] for s in samples)
    sxy = sum(s[0] * s[1] for s in samples)
    denom = n * sxx - sx * sx
    if denom == 0:
        return 0.0, sy / n
    a = (n * sxy - sx * sy) / denom
    b = (sy - a * sx) / n
    return max(a, 0.0), max(b, 0.0)


def cost_model_for(model_name: str = "mistral-7b",
                   chips_per_instance: int = 1) -> CostModel:
    """Convenience constructors for the paper's two models + generic sizes."""
    presets = {
        "mistral-7b": ModelSpec("mistral-7b", 7.2e9, 7.2e9, 32, 4096, 8, 128),
        "llama3-70b": ModelSpec("llama3-70b", 70e9, 70e9, 80, 8192, 8, 128),
        "smollm-360m": ModelSpec("smollm-360m", 0.36e9, 0.36e9, 32, 960, 5, 64),
    }
    spec = presets.get(model_name)
    if spec is None:
        spec = presets["mistral-7b"]
    hw = HardwareSpec(chips_per_instance=chips_per_instance)
    return CostModel(hw=hw, model=spec)
