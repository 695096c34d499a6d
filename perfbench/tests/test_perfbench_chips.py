"""A cell of ``chips`` n: n single-card E2 instances, on the CPU at a tiny
size. With one chip the harness makes the one-instance call it always
made; with two, both instances serve, the result line is well formed and
the engines' counters are read as their sums."""

import pytest
import torch

import _tiny
from benchlib import cell as C
from benchlib import serve
from benchlib.spec import load_cell


@pytest.fixture(scope="module")
def tiny2(tmp_path_factory):
    torch.set_num_threads(2)
    return _tiny.make(tmp_path_factory.mktemp("tiny2"), chips=2)


class _Calls(Exception):
    pass


@pytest.mark.parametrize("chips", [1, 2])
def test_build_makes_one_instance_a_chip(tmp_path, monkeypatch, chips):
    from repro_torch.serving import cluster
    calls = []

    def record(*args, **kw):
        calls.append((args, kw))
        raise _Calls

    monkeypatch.setattr(cluster, "ClusterRuntime", record)
    root = _tiny.make(tmp_path, chips=chips)
    cell = load_cell("tiny.tb", root=root, bench_dir=root / "bench")
    with pytest.raises(_Calls):
        C.build(cell, 3, "cpu")
    (args, kw), = calls
    assert args[0].name == "tiny" and args[2] == chips
    assert args[3].paged is True and args[3].chunk_size == 32
    extra = {"chips_per_instance": [1, 1], "devices": ["cpu", "cpu"]}
    assert set(kw) == {"cost_model", "policy", "device"} | (
        set(extra) if chips > 1 else set())
    assert kw["policy"] == "e2" and kw["device"] == "cpu"
    if chips > 1:
        assert {k: kw[k] for k in extra} == extra


def test_a_two_chip_cell_runs_and_reports(tiny2):
    out = _tiny.run(tiny2, seed=21)
    assert out["correct"] is True
    assert out["attempted"] > 10 and out["failed"] == 0
    assert out["device"]["count"] == 2
    assert set(out["metrics"]) == {"setup_s", "ttft_p95_ms", "tpot_p50_ms",
                                   "latency_mean_s", "latency_p95_s"}
    assert list(out)[-1] == "compared"


def test_a_two_chip_traced_run_sums_the_instances_counters(tiny2,
                                                           monkeypatch):
    seen = []
    real = serve.Loop._snapshot

    def checked(loop):
        snap = real(loop)
        per = [{k: e.stats[k] for k in serve.COUNTED}
               for e in loop.cluster.engines.values()]
        assert len(per) == 2
        for k in serve.COUNTED:
            assert snap[k] == sum(p[k] for p in per), k
        seen.append(per)
        return snap

    monkeypatch.setattr(serve.Loop, "_snapshot", checked)
    out = _tiny.run(tiny2, seed=22, trace=True)
    assert out["correct"] is True
    # both instances served the set-up's requests and the window's
    assert all(p["iterations"] > 0 for p in seen[0])
    assert all(p["prefilled_tokens"] > seen[0][i]["prefilled_tokens"]
               for i, p in enumerate(seen[-1]))
    m = out["metrics"]
    for k in ("route_ms", "reuse_share", "step_ms.mixed", "step_ms.decode",
              "mfu.mixed", "mfu.decode", "launches_per_step",
              "device_idle_share", "tokens_per_step"):
        assert k in m, k
    assert 0 < m["reuse_share"]["value"] < 100
    dev = out["device"]
    assert dev["count"] == 2 and 0 < dev["busy_s"] <= dev["window_s"]
    assert out["breakdown"]["device_ops"]


def test_lanes_are_grouped_into_one_call_an_instance():
    s = serve.StepRecord(0.0, 1.0, "decode", 0, [], [10, 20, 30], 3, 0,
                         True, True, [1, 0, 1])
    assert s.decode_calls() == [[10, 30], [20]]
    one = serve.StepRecord(0.0, 1.0, "decode", 0, [], [10, 20], 2, 0,
                           True, True)
    assert one.decode_calls() == [[10, 20]]


def test_the_model_share_is_of_every_chips_peak():
    from types import SimpleNamespace
    from benchlib.flops import PEAK_FLOPS, Dims, step_flops
    from benchlib.spec import BENCH_DIR, load_module
    mfu = load_module(BENCH_DIR / "metrics" / "mfu.decode.py", "mfu_chips")
    dims = Dims(2, 8, 2, 1, 4, 16, 100, 0, 0, 2)
    s = serve.StepRecord(0.0, 0.5, "decode", 0, [], [10, 20], 2, 0, False,
                         True, [0, 1])
    one = mfu.read(SimpleNamespace(steps=[s], dims=dims, chips=1))
    two = mfu.read(SimpleNamespace(steps=[s], dims=dims, chips=2))
    assert one == pytest.approx(100 * step_flops(dims, 2, 2, 30)
                                / (0.5 * PEAK_FLOPS))
    assert two == pytest.approx(one / 2)


def _union(ivs, t0, t1):
    """Seconds of [t0, t1] under any of the intervals, by hand."""
    total, end = 0.0, t0
    for s, e in sorted((max(s, t0), min(e, t1)) for s, e in ivs):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def test_a_two_card_trace_is_read_card_by_card(tiny2, monkeypatch):
    """The profiler's events carry cards 0 and 1 (on the CPU, the host's
    operators: those that start in the first half of their span on card 0,
    the rest on card 1); the result line's busy time and idle share are the
    mean of each card's, the launches every card's."""
    from benchlib import devtrace
    slices = []
    init, ops, stop = (devtrace.DeviceProfiler.__init__,
                       devtrace.DeviceProfiler._ops,
                       devtrace.DeviceProfiler.stop)

    def two_cards(self, device_type="cuda", chips=1):
        init(self, device_type, chips)
        self._chips = chips     # where the CPU's rehearsal traces one

    def by_half(self):
        got, card = ops(self)
        if self._chips == 1:
            return got, card
        mid = (min(s for _, s, _ in got) + max(e for _, _, e in got)) / 2
        return got, [int(s >= mid) for _, s, _ in got]

    def kept(self):
        sl = stop(self)
        slices.append(sl)
        return sl

    monkeypatch.setattr(devtrace.DeviceProfiler, "__init__", two_cards)
    monkeypatch.setattr(devtrace.DeviceProfiler, "_ops", by_half)
    monkeypatch.setattr(devtrace.DeviceProfiler, "stop", kept)
    views, view = [], C.RunView
    monkeypatch.setattr(C, "RunView", lambda *a: views.append(view(*a))
                        or views[-1])
    out = _tiny.run(tiny2, seed=23, trace=True)
    assert out["correct"] is True
    sl, = [x for x in slices if x.chips == 2]
    assert sl.chips == 2 and set(sl.card) == {0, 1}
    each = [_union([(s, e) for (_, s, e), c in zip(sl.ops, sl.card)
                    if c == k], sl.t0, sl.t1) for k in (0, 1)]
    whole = _union([(s, e) for _, s, e in sl.ops], sl.t0, sl.t1)
    dev = out["device"]
    assert dev["busy_s"] == pytest.approx(sum(each) / 2)
    assert dev["busy_s"] < 0.75 * whole          # not the union's
    idle = out["metrics"]["device_idle_share"]["value"]
    assert idle == pytest.approx(100 * (1 - sum(each) / 2 / sl.window_s))
    steps = [s for s in views[0].slice_steps if s.kind != "idle"]
    assert out["metrics"]["launches_per_step"]["value"] == pytest.approx(
        len(sl.kernels()) / len(steps))
    assert sl.idle_by_host([]) == pytest.approx(
        {"other": sl.window_s - sum(each) / 2})


class _Engine:
    def __init__(self):
        self.stats = {"iterations": 0}


class _Cluster:
    def __init__(self, n):
        self.engines = {i: _Engine() for i in range(n)}


@pytest.mark.parametrize("serves,rounds", [
    ([[0, 1]], 1),            # E2 spread the first round
    ([[0], [0, 1]], 2),       # instance 1 idle after the first
    ([[0]] * 4, None),        # never: set-up fails
])
def test_set_up_serves_until_every_instance_has_run(monkeypatch, serves,
                                                    rounds):
    cl, sent = _Cluster(2), []

    def serve_to_end(cluster, reqs):
        for i in serves[len(sent)]:
            cluster.engines[i].stats["iterations"] += 1
        sent.append(reqs)

    monkeypatch.setattr(C, "serve_to_end", serve_to_end)
    make = lambda toks, n: (toks, n)          # noqa: E731
    if rounds is None:
        with pytest.raises(RuntimeError, match=r"instances \[1\]"):
            C.first_requests(cl, make, 100, 9)
        assert len(sent) == 4
        return
    C.first_requests(cl, make, 100, 9)
    assert len(sent) == rounds and all(len(r) == 4 for r in sent)
    # the first round draws what one instance's two requests always drew
    one = []
    monkeypatch.setattr(C, "serve_to_end", lambda c, reqs: (
        one.append(reqs), c.engines[0].stats.update(iterations=1)))
    C.first_requests(_Cluster(1), make, 100, 9)
    assert one[0] == sent[0][:2]
