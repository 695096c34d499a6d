"""The program's host spans read beside the harness's records
(``benchlib/spans.py``) against hand counts, ``step_phases.py`` on a tiny
cell on the CPU, and, on the card, the spans and the device trace on one
clock."""

import json
import os
import random
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

import _tiny
import step_phases
from benchlib import spans as S
from benchlib.devtrace import DeviceSlice
from benchlib.serve import StepRecord
from benchlib.spec import BENCH_DIR, ROOT, load_cell


def test_idle_goes_to_the_innermost_span_and_the_parts_sum_to_it():
    sl = DeviceSlice(0.0, 10.0, [("k", 0.0, 1.0), ("k", 9.0, 10.0)])
    idle = S.idle_by_innermost(sl, [
        ("step", 0.5, 8.0), ("engine.lower", 1.5, 2.0),
        ("model.dispatch", 2.0, 6.0), ("moe.sync", 3.0, 3.5),
        ("engine.fetch", 6.0, 7.0), ("stamp", 8.0, 8.5)])
    assert idle == pytest.approx({
        "step": 0.5 + 1.0, "engine.lower": 0.5, "model.dispatch": 3.5,
        "moe.sync": 0.5, "engine.fetch": 1.0, "stamp": 0.5, "other": 0.5})
    assert sum(idle.values()) == pytest.approx(sl.window_s - sl.busy_s)
    # of two spans that begin together, the shorter is the inner one
    assert S.idle_by_innermost(sl, [("a", 1.0, 5.0), ("b", 1.0, 3.0)]) == \
        pytest.approx({"b": 2.0, "a": 2.0, "other": 4.0})


def test_without_overlaps_it_is_idle_by_host_exactly():
    rnd = random.Random(3)
    for _ in range(20):
        ops, t = [], 0.0
        while t < 50.0:
            s = t + rnd.uniform(0.0, 2.0)
            t = s + rnd.uniform(0.01, 1.0)
            ops.append(("k", s, t))
        spans, t = [], -1.0
        while t < 52.0:
            s = t + rnd.uniform(0.0, 3.0)
            t = s + rnd.uniform(0.01, 4.0)
            spans.append((rnd.choice(["step", "stamp", "wait"]), s, t))
        sl = DeviceSlice(0.0, 50.0, ops)
        assert S.idle_by_innermost(sl, spans) == sl.idle_by_host(spans)


def _step(t0, t1, kind):
    return StepRecord(t0, t1, kind, 0, [], [], 0, 0, False, True)


def test_per_step_phases_by_hand():
    prog = [("sched.form_batch", 0.0, 0.001), ("engine.admit", 0.001, 0.002),
            ("engine.lower", 0.002, 0.004), ("model.dispatch", 0.004, 0.009),
            ("moe.sync", 0.005, 0.006), ("engine.fetch", 0.009, 0.010),
            ("sched.complete", 0.010, 0.012),
            ("model.dispatch", 0.020, 0.022), ("engine.fetch", 0.022, 0.030),
            ("model.dispatch", 0.045, 0.048)]       # outside every step
    steps = [_step(0.0, 0.013, "decode"), _step(0.019, 0.031, "mixed"),
             _step(0.040, 0.044, "decode"), _step(0.050, 0.060, "idle")]
    w = S.Within(prog)
    assert S.per_step_ms(steps, w, ("model.dispatch",), ("decode",)) == \
        pytest.approx((5.0 + 0.0) / 2)
    assert S.per_step_ms(steps, w, S.HOST, ("decode",)) == \
        pytest.approx((1.0 + 1.0 + 2.0 + 2.0) / 2)
    assert S.per_step_ms(steps, w, ("moe.sync",), ("mixed", "decode")) == \
        pytest.approx(1.0 / 3)
    assert S.per_step_ms(steps, w, ("engine.fetch",), ("mixed",)) == \
        pytest.approx(8.0)
    # the parent program records no spans: nothing to read
    assert S.per_step_ms(steps, S.Within([]), S.HOST, ("decode",)) is None
    assert S.per_step_ms([], w, S.HOST, ("decode",)) is None


def test_idle_shares_queue_waits_and_pad_share_by_hand():
    sl = DeviceSlice(0.0, 10.0, [("k", 0.0, 4.0)])
    spans = [("step", 4.0, 10.0), ("sched.form_batch", 4.0, 5.0),
             ("model.dispatch", 5.0, 8.0), ("moe.sync", 6.0, 7.0),
             ("sched.complete", 8.0, 9.0)]
    assert S.idle_share(sl, spans, S.DISPATCH) == pytest.approx(30.0)
    assert S.idle_share(sl, spans, S.HOST) == pytest.approx(20.0)
    assert S.idle_share(sl, spans[:1], S.HOST) is None
    assert S.idle_share(None, spans, S.HOST) is None

    def tracked(phase, durs):
        if durs is None:
            return SimpleNamespace(phase=phase, req=SimpleNamespace(
                trace=None))
        ev = [{"name": "queue", "kind": "end", "dur": d} for d in durs]
        return SimpleNamespace(phase=phase, req=SimpleNamespace(
            trace=SimpleNamespace(events=ev)))
    assert S.queue_waits([tracked("window", [0.5, 9.0]),
                          tracked("warm", [7.0]), tracked("window", None),
                          tracked("window", [0.25])]) == [0.5, 0.25]

    open_ = {"fused_padded_tokens": 10, "fused_slot_tokens": 100}
    close = {"fused_padded_tokens": 40, "fused_slot_tokens": 220}
    assert S.pad_share({"open": open_, "close": close}) == \
        pytest.approx(25.0)
    assert S.pad_share({"open": {"reused_tokens": 0},
                        "close": {"reused_tokens": 1}}) is None


@pytest.fixture(scope="module")
def tiny_moe(tmp_path_factory):
    torch.set_num_threads(2)
    return _tiny.make(tmp_path_factory.mktemp("tiny_moe"), moe=True)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(2)
    return _tiny.make(tmp_path_factory.mktemp("tiny"))


def _measure(root, telemetry=True):
    cell = load_cell("tiny.tb", root=root, bench_dir=root / "bench")
    return step_phases.measure(cell, 11, 2, device="cpu",
                               telemetry=telemetry)


NEW = ("dispatch_ms.decode", "host_ms.decode", "idle_share.dispatch",
       "idle_share.host", "queue_wait_p95_ms", "pad_share.mixed")


def test_step_phases_reads_the_program_spans_of_a_tiny_cell(tiny):
    out = _measure(tiny)
    assert out["failed"] == 0 and out["steps"]["decode"] > 0
    for k in NEW:
        assert out[k] is not None and out[k] > 0, k
    assert out["moe_sync_ms"] is None
    assert 0 < out["pad_share.mixed"] < 100
    assert out["dropped_spans"] == 0
    # the phases of a decode step lie within its wall
    dec = out["phase_ms"]["decode"]
    assert sum(v for k, v in dec.items() if k != "moe.sync") <= \
        out["step_ms.decode"]
    # program span names carry the idle time that lay inside "step"
    gaps = dict(out["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(out["idle_s"], rel=1e-9)
    assert any(k in gaps for k in S.PHASES)
    # without the telemetry there are no spans and no request traces to
    # read; the counters are there all the same
    off = _measure(tiny, telemetry=False)
    assert all(off[k] is None for k in NEW if k != "pad_share.mixed")
    assert off["pad_share.mixed"] > 0 and off["step_ms.decode"] > 0


def test_step_phases_reads_the_moe_syncs_of_a_tiny_moe_cell(tiny_moe):
    out = _measure(tiny_moe)
    assert out["moe_sync_ms"] > 0
    assert out["phase_ms"]["decode"]["moe.sync"] <= \
        out["phase_ms"]["decode"]["model.dispatch"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


# run in a process of its own, as a benchmark run's slice is: in a process
# that profiled before a kernel was built with nvcc, later profiler sessions
# can capture no device event at all (PERF.md §7)
CLOCK = """
import json, time, torch
from benchlib import devtrace
from repro_torch.serving.telemetry import Telemetry
devtrace.warm()
torch.cuda._sleep(1000)
torch.cuda.synchronize()
tel = Telemetry()
p = devtrace.DeviceProfiler()
p.start()
torch.cuda.synchronize()
t0 = time.perf_counter()
torch.cuda._sleep(4_000_000)
torch.cuda.synchronize()
tel.span("sleep", t0)
sl = p.stop()
print(json.dumps({"kernels": [k[1:] for k in sl.kernels()],
                  "span": tel.spans[0][1:]}))
"""


@pytest.mark.cuda
def test_the_program_spans_and_the_device_trace_share_one_clock():
    """A host span closed after a synchronize holds the ~2 ms kernel it
    launched, on the device trace mapped onto the loop's clock, within
    50 us at either end."""
    _card()
    path = os.pathsep.join([str(BENCH_DIR), str(ROOT / "src")])
    r = subprocess.run([sys.executable, "-c", CLOCK], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=path))
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.splitlines()[-1])
    s, e = max(got["kernels"], key=lambda k: k[1] - k[0])
    h0, h1 = got["span"]
    print(f"clock: kernel {1e3 * (e - s):.3f} ms; starts "
          f"{1e6 * (s - h0):.1f} us after the span opens, ends "
          f"{1e6 * (h1 - e):.1f} us before it closes")
    assert e - s > 1e-3
    assert s >= h0 - 50e-6 and e <= h1 + 50e-6
