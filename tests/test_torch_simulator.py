"""The port's discrete-event cluster simulator and cost-model fit, held
to the JAX package's.

Each scenario of the JAX package's simulator tests
(tests/test_simulator_workloads.py, tests/test_faults.py,
tests/test_prefetch.py, tests/test_spec_pricing.py,
tests/test_kv_offload.py, tests/test_telemetry.py) runs through both
simulators on the same requests (each side generated by its own package
from the same seeds), with the port's cost model given the JAX
package's hardware constants (``HardwareSpec`` through
``dataclasses.asdict``, in place of the port's ``cost_model_for``). The
two are the same pure-Python arithmetic on the same inputs, so every
number is held equal exactly, with no tolerance: the ``summary()``
dicts, each request's (instance, TTFT, latency), ``fault_stats()``, the
global and local scheduler stats and the telemetry exports (request ids
taken as offsets from the run's first, since each package numbers its
requests from its own counter). The scenarios' own assertions are
checked on the port's side.

``CostModel.fit`` is held to the JAX package's on the same (tokens,
seconds) samples, and the sample collector of ``chip_smoke.py``'s
simulator phase runs on a reduced float32 engine on the CPU.
"""

import dataclasses
import math
import sys
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

import repro.data as jdata
from repro.core import cost_model as JCM
from repro.core.request import Request as JRequest
from repro.core.request import RequestState as JRequestState
from repro.serving import simulator as JS
from repro.serving.faults import FaultConfig as JFaultConfig
from repro.serving.faults import FaultInjector as JFaultInjector
from repro.serving.telemetry import Telemetry as JTelemetry
import repro_torch.data as tdata
from repro_torch import configs as tconfigs
from repro_torch.core import cost_model as TCM
from repro_torch.core.request import Request as TRequest
from repro_torch.core.request import RequestState as TRequestState
from repro_torch.serving import simulator as TS
from repro_torch.serving.faults import FaultConfig as TFaultConfig
from repro_torch.serving.telemetry import Telemetry as TTelemetry

ROOT = Path(__file__).resolve().parents[1]

JAX_SIDE = SimpleNamespace(
    S=JS, Request=JRequest, RequestState=JRequestState, data=jdata,
    FaultConfig=JFaultConfig, Telemetry=JTelemetry,
    fault_keys=set(JFaultInjector(JFaultConfig()).stats))
PORT_SIDE = SimpleNamespace(
    S=TS, Request=TRequest, RequestState=TRequestState, data=tdata,
    FaultConfig=TFaultConfig, Telemetry=TTelemetry, fault_keys=None)


def _reference_cost_model_for(model_name="mistral-7b",
                              chips_per_instance=1):
    """The port's CostModel on the JAX package's hardware constants."""
    hw = TCM.HardwareSpec(**{**dataclasses.asdict(JCM.HardwareSpec()),
                             "chips_per_instance": chips_per_instance})
    return TCM.CostModel(hw=hw,
                         model=TCM.cost_model_for(model_name).model)


@pytest.fixture
def reference_constants():
    with mock.patch.object(TS, "cost_model_for",
                           _reference_cost_model_for):
        yield


# ---- what a run leaves, normalised for comparison ---------------------------

def _ids_as_offsets(obj, base):
    if isinstance(obj, dict):
        return {(k - base if k.__class__ is int else k):
                (v - base if k in ("id", "request_id") else
                 _ids_as_offsets(v, base)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_ids_as_offsets(v, base) for v in obj]
    return obj


def _record(sim, res, requests, tel=None):
    """Everything a run leaves that the two simulators must agree on."""
    base = min(r.request_id for r in requests)
    out = dict(
        summary=res.summary(), makespan=res.makespan,
        finished=[(r.request_id - base, r.instance, r.ttft(), r.latency())
                  for r in res.finished],
        failed=[(r.request_id - base, r.instance, r.state.value, r.retries)
                for r in res.failed],
        fault_stats=sim.fault_stats(), gs_stats=dict(sim.gs.stats),
        local_stats={i: dict(ls.stats) for i, ls in sim.locals.items()},
        cm=dataclasses.asdict(sim.cm))
    if tel is not None:
        out["telemetry"] = dict(
            snapshot=_ids_as_offsets(tel.snapshot(), base),
            prometheus=tel.to_prometheus(),
            events=_ids_as_offsets(tel.events, base),
            traces=[_ids_as_offsets(tr.to_dict(), base)
                    for tr in tel.traces],
            breakdowns=[tr.breakdown() for tr in tel.traces])
    return out


# ---- the scenarios ------------------------------------------------------------

def _poisson_stream(side, wl, n, rps, wl_seed, arr_seed):
    d = side.data
    return d.assign_arrivals(d.gen_workload(wl, n, seed=wl_seed),
                             d.poisson_arrivals(n, rps, seed=arr_seed))


def _shared_prefix(side, n, shared_len=256, tail=64, out=8, spacing=0.05,
                   seed=0):
    """tests/test_faults.py's and tests/test_telemetry.py's stream."""
    rng = np.random.default_rng(seed)
    shared = tuple(rng.integers(1, 1 << 20, shared_len).tolist())
    return [side.Request(tokens=shared
                         + tuple(rng.integers(1, 1 << 20, tail).tolist()),
                         max_new_tokens=out, arrival_time=i * spacing)
            for i in range(n)]


def _bursts(side, n_agents=8, prefix=3000, tail=150, waves=3, seed=0):
    """tests/test_prefetch.py's warm-up wave and re-hit bursts."""
    rng = np.random.default_rng(seed)
    prefixes = [tuple(rng.integers(1, 1 << 20, prefix).tolist())
                for _ in range(n_agents)]
    warm, t = [], 0.0
    for p in prefixes:
        warm.append(side.Request(tokens=p + tuple(
            rng.integers(1, 1 << 20, tail).tolist()),
            max_new_tokens=8, arrival_time=t))
        t += 1.0
    bursts, t0 = [], t + 4.0
    for w in range(waves):
        tw = t0 + w * 6.0
        for i, p in enumerate(prefixes):
            bursts.append(side.Request(tokens=p + tuple(
                rng.integers(1, 1 << 20, tail).tolist()),
                max_new_tokens=8, arrival_time=tw + 0.002 * i))
    return warm, bursts


def _thrash(side):
    """tests/test_kv_offload.py's capacity-pressured rounds."""
    rng = np.random.default_rng(0)
    prefixes = [tuple(rng.integers(1, 50000, 3000).tolist())
                for _ in range(6)]
    reqs, t = [], 0.0
    for _round in range(3):
        for pref in prefixes:
            reqs.append(side.Request(
                tokens=pref + tuple(rng.integers(1, 50000, 40).tolist()),
                max_new_tokens=8, arrival_time=t))
            t += 1.0
    return reqs


def _run(side, reqs, tel=None, **cfg):
    sim = side.S.Simulator(side.S.SimConfig(**cfg), telemetry=tel)
    res = sim.run(reqs)
    sim.check_invariants()
    return sim, res, _record(sim, res, reqs, tel)


def all_finish(side):
    reqs = _poisson_stream(side, "toolbench", 120, 8.0, 1, 1)
    sim, res, rec = _run(side, reqs, num_instances=2)
    assert len(res.finished) == 120
    assert all(r.finish_time >= r.arrival_time for r in res.finished)
    assert all(r.first_token_time >= r.arrival_time for r in res.finished)
    return [rec]


def e2_beats_rr(wl, rps):
    def scenario(side):
        recs = {}
        for pol in ("e2", "rr"):
            reqs = _poisson_stream(side, wl, 250, rps, 2, 3)
            recs[pol] = _run(side, reqs, num_instances=4, policy=pol)[2]
        e2, rr = recs["e2"]["summary"], recs["rr"]["summary"]
        assert e2["avg_latency"] < rr["avg_latency"]
        assert e2["cache_hit_frac"] > rr["cache_hit_frac"]
        return [recs["e2"], recs["rr"]]
    return scenario


def rate_sweep(side):
    recs = [_run(side, _poisson_stream(side, "toolbench", 200, rps, 2, 4),
                 num_instances=2)[2] for rps in (4.0, 30.0)]
    assert recs[1]["summary"]["avg_latency"] \
        > recs[0]["summary"]["avg_latency"]
    return recs


def straggler(side):
    recs = []
    for aware in (True, False):
        reqs = _poisson_stream(side, "toolbench", 200, 8.0, 2, 5)
        recs.append(_run(side, reqs, num_instances=4,
                         speed_factors={0: 6.0} if aware else None)[2])
    assert recs[0]["summary"]["avg_latency"] < 10.0
    return recs


def _fault_cfg(side, **extra):
    return dict(num_instances=3, capacity_tokens=2_000,
                host_capacity_tokens=20_000, prefetch_budget_tokens=512,
                faults=side.FaultConfig(seed=21, crash_at={0: 0.4},
                                        dma_failure_rate=0.05,
                                        notify_drop_rate=0.02),
                heartbeat_interval=0.1, suspect_misses=2, dead_misses=5,
                reconcile_every=0.5, retry_budget=3, retry_backoff=0.1,
                **extra)


def fault_parity(side):
    reqs = _shared_prefix(side, 40, seed=21)
    sim, res, rec = _run(side, reqs, **_fault_cfg(side))
    assert len(res.finished) + len(res.failed) == 40
    assert res.stats["crashes"] == 1.0
    assert not sim.gs.instances[0].alive
    assert sim.gs.stats["detected_dead"] == 1
    assert sim.fault_counters["recovered_requests"] > 0
    sim.reconcile_all(res.makespan)
    for i, ls in sim.locals.items():
        if i in sim._crashed:
            continue
        d = ls.residency_digest()
        assert sim.gs.instances[i].cached_tokens \
            == sum(n for _, n in d["device"])
        assert sim.gs.instances[i].host_cached_tokens \
            == sum(n for _, n in d["host"])
    rec["after_reconcile"] = {i: (s.cached_tokens, s.host_cached_tokens)
                              for i, s in sim.gs.instances.items()}
    if side.fault_keys is not None:
        assert side.fault_keys <= set(res.stats)
    for k in ("retries", "failed_terminal", "failed_no_survivors",
              "recovered_requests"):
        assert k in res.stats
    return [rec]


def zero_survivors(side):
    reqs = _shared_prefix(side, 10, spacing=0.2, seed=5)
    sim, res, rec = _run(side, reqs, num_instances=1, capacity_tokens=4_000,
                         faults=side.FaultConfig(seed=5, crash_at={0: 0.3}),
                         retry_budget=2, retry_backoff=0.05)
    assert len(res.finished) + len(res.failed) == 10
    assert res.failed
    assert all(r.state == side.RequestState.FAILED for r in res.failed)
    assert res.stats["failed_no_survivors"] > 0
    return [rec]


def retry_exhaustion(side):
    """Two instances, both crashed in turn under the detector: stranded
    requests burn their one retry and fail on the budget."""
    reqs = _shared_prefix(side, 16, spacing=0.05, seed=9)
    sim, res, rec = _run(side, reqs, num_instances=2, capacity_tokens=4_000,
                         faults=side.FaultConfig(seed=9,
                                                 crash_at={0: 0.2, 1: 0.5}),
                         heartbeat_interval=0.1, suspect_misses=1,
                         dead_misses=2, retry_budget=1, retry_backoff=0.05)
    assert len(res.finished) + len(res.failed) == 16
    assert res.stats["failed_terminal"] + res.stats["failed_no_survivors"] \
        == len(res.failed) > 0
    return [rec]


def faultfree_plumbing(side):
    base = _run(side, _shared_prefix(side, 20, seed=3), num_instances=2,
                capacity_tokens=4_000)
    wired = _run(side, _shared_prefix(side, 20, seed=3), num_instances=2,
                 capacity_tokens=4_000, faults=side.FaultConfig(seed=3))
    r1, r2 = base[1], wired[1]
    assert r1.makespan == r2.makespan
    assert [r.instance for r in r1.finished] \
        == [r.instance for r in r2.finished]
    assert r1.stats["gs_exploit"] == r2.stats["gs_exploit"]
    return [base[2], wired[2]]


def _prefetch_sim(side, pf):
    return side.S.Simulator(side.S.SimConfig(
        num_instances=2, capacity_tokens=6500, host_capacity_tokens=40000,
        chunk_size=2048, max_batch_tokens=8192, prefetch_budget_tokens=pf))


def prefetch_off_ttft(side):
    recs, summ = [], {}
    for pf in (0, 20000):
        sim = _prefetch_sim(side, pf)
        warm, bursts = _bursts(side)
        recs.append(_record(sim, sim.run(warm), warm))
        res = sim.run(bursts)
        sim.check_invariants()
        recs.append(_record(sim, res, bursts))
        summ[pf] = res.summary()
        live = {i: sum(r["reserved"] for r in ls._prefetch_recs.values()
                       if not r["cancelled"] and not r["landed"])
                for i, ls in sim.locals.items()}
        assert live == {i: ls.prefetch_reserved_tokens
                        for i, ls in sim.locals.items()}
    base, pf = summ[0], summ[20000]
    assert pf["prefetch_issued"] > 0 and pf["prefetch_hit"] > 0
    assert pf["prefetch_overlap_frac"] > 0
    assert pf["restored_tokens"] < base["restored_tokens"]
    assert pf["avg_ttft"] < base["avg_ttft"]
    assert pf["p99_ttft"] <= base["p99_ttft"]
    return recs


def prefetch_randomized(side):
    warm, bursts = _bursts(side, n_agents=6, prefix=2000, tail=100,
                           waves=4, seed=3)
    sim = _prefetch_sim(side, 10000)
    sim.run(warm)
    res = sim.run(bursts)
    sim.check_invariants()
    assert len(res.finished) == len(bursts)
    assert all(ls.used_tokens >= 0 for ls in sim.locals.values())
    return [_record(sim, res, bursts)]


def spec_pricing(side):
    plain = side.S.Simulator(side.S.SimConfig(num_instances=1))
    spec = side.S.Simulator(side.S.SimConfig(num_instances=1, spec_k=4,
                                             spec_acceptance=0.95))
    assert plain.cm.spec_k == 0 and spec.cm.spec_k == 4
    assert spec.cm.decode_time(100) < plain.cm.decode_time(100)
    recs = [dict(decode_time=(plain.cm.decode_time(100),
                              spec.cm.decode_time(100)))]
    for k in (0, 4):
        reqs = _poisson_stream(side, "toolbench", 60, 6.0, 4, 2)
        recs.append(_run(side, reqs, num_instances=2, spec_k=k,
                         spec_acceptance=0.8)[2])
    assert recs[2]["summary"]["avg_latency"] \
        != recs[1]["summary"]["avg_latency"]
    return recs


def tier_counters(side):
    tiered = _run(side, _thrash(side), num_instances=2,
                  capacity_tokens=5000, host_capacity_tokens=40_000)[2]
    s = tiered["summary"]
    for key in ("demoted_tokens", "restored_tokens", "restore_hit_frac",
                "cache_hit_frac"):
        assert key in s
    assert s["demoted_tokens"] > 0 and s["restored_tokens"] > 0
    assert s["restore_hit_frac"] > 0
    base = _run(side, _thrash(side), num_instances=2, capacity_tokens=5000,
                host_capacity_tokens=0)[2]
    assert base["summary"]["restored_tokens"] == 0
    assert base["summary"]["restore_hit_frac"] == 0
    return [tiered, base]


def telemetry(side):
    tel = side.Telemetry()
    reqs = _shared_prefix(side, 40, seed=21)
    sim, res, rec = _run(side, reqs, tel=tel, **_fault_cfg(side))
    assert len(res.finished) + len(res.failed) == 40
    assert tel.open_spans() == {}
    assert tel.events_named("crash") and tel.events_named("recover")
    quiet = _run(side, _shared_prefix(side, 30, seed=11),
                 tel=side.Telemetry(enabled=False), num_instances=2,
                 capacity_tokens=2_000, host_capacity_tokens=20_000,
                 prefetch_budget_tokens=512)[2]
    loud = _run(side, _shared_prefix(side, 30, seed=11),
                tel=side.Telemetry(), num_instances=2,
                capacity_tokens=2_000, host_capacity_tokens=20_000,
                prefetch_budget_tokens=512)[2]
    assert quiet["summary"] == loud["summary"]
    return [rec, quiet, loud]


SCENARIOS = {
    "all_finish": all_finish,
    "e2_beats_rr_toolbench": e2_beats_rr("toolbench", 10.0),
    "e2_beats_rr_videoqa": e2_beats_rr("videoqa", 2.0),
    "rate_sweep": rate_sweep,
    "straggler": straggler,
    "fault_parity": fault_parity,
    "zero_survivors": zero_survivors,
    "retry_exhaustion": retry_exhaustion,
    "faultfree_plumbing": faultfree_plumbing,
    "prefetch_off_ttft": prefetch_off_ttft,
    "prefetch_randomized": prefetch_randomized,
    "spec_pricing": spec_pricing,
    "tier_counters": tier_counters,
    "telemetry": telemetry,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_simulator_matches_jax_simulator(name, reference_constants):
    port = SCENARIOS[name](PORT_SIDE)
    assert port == SCENARIOS[name](JAX_SIDE)


def test_simulator_constants_are_the_jax_packages_under_the_patch(
        reference_constants):
    for chips in (1, 4):
        got = TS.Simulator(TS.SimConfig(chips_per_instance=chips)).cm
        want = JS.Simulator(JS.SimConfig(chips_per_instance=chips)).cm
        assert got.hw.name == want.hw.name == "tpu-v5e"
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---- the port's own default: the H100 data sheet ---------------------------

def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_default_simulator_runs_on_the_h100_model():
    """Unpatched, the port's simulator prices on the H100 data sheet,
    and chip_smoke's Figure 3 grid (the rate-scaled quick grid of
    bench_e2e) finishes every toolbench run with the invariants holding;
    its runs at x1 equal an unpatched ``simulate``."""
    sim = TS.Simulator(TS.SimConfig())
    assert sim.cm.hw.name == "h100-sxm"
    assert dataclasses.asdict(sim.cm) \
        == dataclasses.asdict(TCM.cost_model_for("mistral-7b"))
    C = _chip_smoke()
    grid = {"toolbench": C.FIG3_GRID["toolbench"]}
    rows = C.fig3_grid(TS, {"sheet": TCM.cost_model_for("mistral-7b")},
                       tdata.gen_workload, tdata.poisson_arrivals,
                       tdata.assign_arrivals, grid=grid)
    assert [(r["mult"], r["rps"]) for r in rows] \
        == [(m, 8.0 * m) for m in C.FIG3_MULTIPLIERS]
    n, rps = grid["toolbench"]
    for pol in ("e2", "rr"):
        s = TS.simulate(_poisson_stream(PORT_SIDE, "toolbench", n, rps, 3, 7),
                        num_instances=4, policy=pol).summary()
        assert (rows[0][f"{pol}_avg"], rows[0][f"{pol}_p99"]) \
            == (s["avg_latency"], s["p99_latency"])
    assert all(r["rr_over_e2_avg"] > 1.0 for r in rows)


# ---- CostModel.fit ------------------------------------------------------------

FIT_CASES = {
    "one_sample": ([(512.0, 0.05)], [(8.0, 0.04)]),
    "one_sample_at_zero": ([(0.0, 0.05)], [(0.0, 0.04)]),
    "collinear": ([(512.0 * k, 0.03 + 2.5e-5 * 512 * k) for k in (1, 2, 4, 8)],
                  [(float(n), 0.045 + 4e-4 * n) for n in (1, 2, 4, 8, 16)]),
    "noisy": ([(512.0, 0.041), (1024.0, 0.052), (2048.0, 0.081),
               (4096.0, 0.139), (4096.0, 0.142)],
              [(1.0, 0.051), (2.0, 0.049), (8.0, 0.053), (32.0, 0.061)]),
    "negative_slope": ([(512.0, 0.09), (4096.0, 0.03)],
                       [(1.0, 0.06), (32.0, 0.01)]),
    "zero_denominator": ([(512.0, 0.05), (512.0, 0.07)],
                         [(8.0, 0.04), (8.0, 0.05), (8.0, 0.03)]),
    "decode_only": ([], [(1.0, 0.05), (16.0, 0.06)]),
}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fit_matches_jax_fit(case):
    pre, dec = FIT_CASES[case]
    want = JCM.cost_model_for("mistral-7b")
    got = _reference_cost_model_for("mistral-7b")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    want.fit(pre, dec)
    got.fit(pre, dec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for s in (pre, dec):
        if s:
            assert TCM._lsq(s) == JCM._lsq(s)
    if case == "collinear":
        assert got.prefill_a == pytest.approx(2.5e-5, rel=1e-9)
        assert got.decode_b == pytest.approx(0.045, rel=1e-9)
    if case == "zero_denominator":
        assert (got.prefill_a, got.prefill_b) == (0.0, (0.05 + 0.07) / 2)
    # the iteration time reads the fitted prefill pair, never the decode
    # pair (as in the JAX package)
    t = got.batch_time(0, 8, 1024.0)
    got.decode_a, got.decode_b = 1.0, 1.0
    assert got.batch_time(0, 8, 1024.0) == t


# ---- chip_smoke's sample collector on the CPU -----------------------------

def test_profile_engine_collects_known_steps_on_cpu():
    from repro_torch.models import zoo
    from repro_torch.serving.engine import Engine, EngineConfig
    C = _chip_smoke()
    cfg = dataclasses.replace(
        tconfigs.reduced(tconfigs.get_config("smollm-360m")), n_layers=2,
        dtype="float32")
    params = zoo.build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    eng = Engine(cfg, params, EngineConfig(
        max_context=128, chunk_size=32, max_batch_tokens=128,
        max_batch_requests=8, page_size=16, capacity_tokens=4096),
        device="cpu")
    before = dict(eng.stats)
    prefill, decode, reps, steps = (1, 2, 4), (1, 2, 4, 8), 2, 3
    prof = C.profile_engine(torch, eng, TRequest, cfg.vocab_size, "cpu",
                            prefill=prefill, decode=decode, prompt=32,
                            ctx=40, reps=reps, steps=steps, gen=16)
    assert [x for x, _ in prof["prefill"]] \
        == [32 * k for k in prefill for _ in range(reps)]
    assert [x for x, _ in prof["decode"]] \
        == [n for n in decode for _ in range(steps)]
    recs = prof["records"]
    assert [(r["x"], r["wall"]) for r in recs] \
        == prof["prefill"] + prof["decode"]
    for r in recs:
        comp = (r["prefilled"], r["decoded"], r["reused"])
        assert comp == ((r["x"], 0, 0) if r["kind"] == "prefill"
                        else (0, r["x"], 0))
        if r["kind"] == "decode":
            assert 40 <= r["ctx"] < 40 + 16
    st = eng.stats
    # every prompt and decode token of the profile, timed or not
    assert st["prefilled_tokens"] - before["prefilled_tokens"] \
        == 32 * (reps + 1) * sum(prefill) + 40 * sum(decode)
    assert st["decode_steps"] - before["decode_steps"] \
        == (reps + 1) * sum(prefill) + 15 * sum(decode)
    assert st["reused_tokens"] == before["reused_tokens"]
    assert prof["dispatches"] == st["model_dispatches"] \
        - before["model_dispatches"] > 0
    fitted = TCM.cost_model_for("smollm-360m")
    fitted.fit(prof["prefill"], prof["decode"])
    coef = C.coefficients(fitted)
    assert all(math.isfinite(v) and v >= 0 for v in coef.values())
    assert coef["prefill_a"] + coef["prefill_b"] > 0
