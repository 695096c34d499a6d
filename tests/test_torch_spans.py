"""The engine step's host spans (``Telemetry.span``): a paged fused engine
serves the same tokens with and without a Telemetry, records its step's
phases in order inside each step, records each routed MoE host sync inside
its dispatch, and records nothing without one. The span list is bounded
and counts its drops; ``snapshot()`` carries no spans."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.core.request import Request
from repro_torch.models import layers, zoo
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.telemetry import Telemetry

torch.set_num_threads(1)

PHASES = ["sched.form_batch", "engine.admit", "engine.lower",
          "model.dispatch", "engine.fetch", "sched.complete"]
ECONF = dict(max_context=96, chunk_size=16, max_batch_tokens=96,
             max_batch_requests=16, capacity_tokens=8192, page_size=16,
             paged=True)
COUNTERS = ("reused_tokens", "prefilled_tokens", "decode_steps",
            "iterations", "model_dispatches", "fused_iterations",
            "fused_padded_tokens", "fused_slot_tokens", "decode_batches",
            "seed_aliased_pages", "seed_copied_pages")


def _model(arch):
    cfg = dataclasses.replace(reduced(ARCHS[arch]), n_layers=2,
                              dtype="float32")
    return cfg, zoo.build(cfg).init(torch.Generator().manual_seed(0), "cpu")


_MODELS = {a: _model(a) for a in ("smollm-360m", "mixtral-8x22b")}


def _prompts(seed=1, n=6, shared_len=29):
    rng = np.random.default_rng(seed)
    shared = tuple(rng.integers(1, 128, shared_len).tolist())
    return [(shared + tuple(rng.integers(1, 128, int(rng.integers(4, 20)))
                            .tolist()), int(rng.integers(3, 7)))
            for _ in range(n)]


def _serve(arch, tel=None, spy=None):
    """Two waves (the second once the first finished), each request
    stepped to its end; returns the outputs, the engine and each step's
    (t0, t1, fused dispatches before, after). ``spy(eng)`` runs on the
    engine before it serves."""
    cfg, params = _MODELS[arch]
    eng = Engine(cfg, params, EngineConfig(**ECONF), device="cpu")
    if spy is not None:
        spy(eng)
    if tel is not None:
        eng.attach_telemetry(tel)
    prompts, done, now, steps = _prompts(), [], 0.0, []
    for wave in (prompts[:2], prompts[2:]):
        for toks, out in wave:
            eng.scheduler.enqueue(Request(tokens=toks, max_new_tokens=out),
                                  now)
        target = len(done) + len(wave)
        for _ in range(500):
            if len(done) == target:
                break
            f0 = eng.stats["fused_iterations"]
            t0 = time.perf_counter()
            done += eng.step(now)
            steps.append((t0, time.perf_counter(), f0,
                          eng.stats["fused_iterations"]))
            now += 0.01
        assert len(done) == target
    return {(r.tokens, r.max_new_tokens): list(r.output_tokens)
            for r in done}, eng, steps


@pytest.mark.parametrize("arch", ["smollm-360m", "mixtral-8x22b"])
def test_telemetry_changes_no_token_and_no_counter(arch):
    plain_out, plain, _ = _serve(arch)
    tel_out, traced, _ = _serve(arch, Telemetry())
    assert tel_out == plain_out
    for k in COUNTERS:
        assert traced.stats[k] == plain.stats[k], k
    assert plain.stats["fused_slot_tokens"] > \
        plain.stats["fused_padded_tokens"] > 0


@pytest.mark.parametrize("arch", ["smollm-360m", "mixtral-8x22b"])
def test_the_slot_counter_counts_each_fused_dispatchs_slots(arch):
    """``fused_slot_tokens`` is Lc * Cb + Ld summed over the fused
    dispatches, read off the tensors each was given; less
    ``fused_padded_tokens`` it is their real chunk tokens and live decode
    lanes (padding lanes carry all-zero table rows). The decode-only
    dispatches add nothing to either."""
    fused, decode_only = [], []

    def spy(eng):
        api = eng.api

        def mixed(params, pages, batch, plan=None):
            Lc, Cb = batch["chunk_tokens"].shape
            Ld = batch["dec_tokens"].shape[0]
            live = int((batch["dec_page_table"] != 0).any(dim=1).sum())
            fused.append((Lc * Cb + Ld, int(batch["chunk_len"].sum())
                          + live, Ld))
            return api.mixed_paged(params, pages, batch, plan=plan)

        def decode(params, pages, batch, plan=None):
            decode_only.append(batch["tokens"].shape[0])
            return api.decode_paged(params, pages, batch, plan=plan)
        eng.api = dataclasses.replace(api, mixed_paged=mixed,
                                      decode_paged=decode)

    _, eng, _ = _serve(arch, spy=spy)
    assert len(fused) == eng.stats["fused_iterations"] > 0
    assert decode_only
    # some fused dispatch carried decode lanes beside its chunks
    assert any(ld > 0 for _, _, ld in fused)
    slots = sum(s for s, _, _ in fused)
    real = sum(r for _, r, _ in fused)
    assert eng.stats["fused_slot_tokens"] == slots
    assert eng.stats["fused_slot_tokens"] \
        - eng.stats["fused_padded_tokens"] == real
    assert 0 < real < slots


@pytest.mark.parametrize("arch", ["smollm-360m", "mixtral-8x22b"])
def test_every_step_records_its_phases_in_order_inside_it(arch):
    tel = Telemetry()
    _, eng, steps = _serve(arch, tel)
    spans = tel.spans
    assert all(t0 <= t1 for _, t0, t1 in spans)
    kinds = set()
    for t0, t1, f0, f1 in steps:
        mine = [sp for sp in spans if t0 <= sp[1] and sp[2] <= t1]
        top = [sp for sp in mine if sp[0] != "moe.sync"]
        assert [n for n, _, _ in top] == PHASES
        # one after the other: each phase begins where or after the
        # last one ended
        assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))
        kinds.add("fused" if f1 > f0 else "decode")
    assert kinds == {"fused", "decode"}
    assert sum(n == "sched.form_batch" for n, _, _ in spans) == len(steps)


def test_each_routed_call_records_a_moe_sync_inside_its_dispatch():
    tel = Telemetry()
    calls = layers.MOE_STATS["calls"]
    _serve("mixtral-8x22b", tel)
    syncs = [sp for sp in tel.spans if sp[0] == "moe.sync"]
    dispatches = [sp for sp in tel.spans if sp[0] == "model.dispatch"]
    assert len(syncs) == layers.MOE_STATS["calls"] - calls > 0
    for _, s, e in syncs:
        assert sum(d0 <= s and e <= d1 for _, d0, d1 in dispatches) == 1
    assert layers.MOE_SPAN_SINK is None


def test_without_telemetry_no_span_and_no_sink(monkeypatch):
    made = []
    real = Telemetry.span
    monkeypatch.setattr(Telemetry, "span",
                        lambda self, *a: made.append(a) or real(self, *a))
    seen = []
    real_routed = layers._routed

    def routed(*a, **k):
        seen.append(layers.MOE_SPAN_SINK)
        return real_routed(*a, **k)
    monkeypatch.setattr(layers, "_routed", routed)
    _, eng, _ = _serve("mixtral-8x22b")
    assert eng.telemetry is None and not made
    assert seen and all(s is None for s in seen)
    assert layers.MOE_SPAN_SINK is None


def test_the_span_list_is_bounded_and_counts_its_drops():
    tel = Telemetry()
    tel.max_spans = 3
    t = time.perf_counter()
    for i in range(5):
        t1 = tel.span(f"s{i}", t)
        assert t1 >= t
        t = t1
    assert [n for n, _, _ in tel.spans] == ["s0", "s1", "s2"]
    assert tel.dropped_spans == 2
    # chained: each span starts where the one before it ended
    assert tel.spans[1][1] == tel.spans[0][2]


def test_the_snapshot_and_export_carry_no_spans():
    tel = Telemetry()
    _serve("smollm-360m", tel)
    assert tel.spans
    snap = tel.snapshot()
    assert set(snap) == {"counters", "gauges", "histograms", "events",
                         "traces"}
    assert snap["events"] == {"n": len(tel.events), "dropped": 0}
    text = tel.to_prometheus() + tel.to_json()
    assert not any(n in text for n in PHASES + ["moe.sync"])
