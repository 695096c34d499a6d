"""A whole run of a cell on the CPU, at a tiny size, with the harness's
look for a chip skipped: pieces found by name, the result line's keys,
and ``correct`` false under each fault the timed path can have."""

import json

import torch
import pytest

import _tiny
from benchlib.spec import BENCH_DIR


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(2)
    return _tiny.make(tmp_path_factory.mktemp("tiny"))


def test_a_cell_added_as_files_is_found_and_runs(tiny):
    out = _tiny.run(tiny)
    assert out["correct"] is True
    assert out["attempted"] > 10 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "ttft_p95_ms", "tpot_p50_ms",
                                   "latency_mean_s", "latency_p95_s"}
    assert list(out)[-1] == "compared"
    assert out["compared"]["gap_max"]["value"] < 1e-4


def test_the_traced_run_reports_the_per_layer_metrics(tiny):
    out = _tiny.run(tiny, trace=True)
    m = out["metrics"]
    assert "tokens_per_step" in m           # the reader dropped in
    for k in ("route_ms", "reuse_share", "step_ms.mixed", "step_ms.decode",
              "mfu.mixed", "mfu.decode", "moe_syncs_per_step",
              "launches_per_step", "device_idle_share",
              "latency_p95_s.traced"):
        assert k in m, k
    assert m["latency_p95_s.traced"]["value"] > 0
    assert 0 < m["reuse_share"]["value"] < 100
    assert "paged_decode_roofline" not in m  # no kernel runs on the CPU
    dev = out["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert out["breakdown"]["device_ops"] and out["breakdown"]["idle_gaps"]
    assert out["correct"] is True


def test_the_tail_latency_is_end_to_end_in_mixtral_and_per_layer_in_mistral():
    from benchlib.spec import load_cell
    cells = {n: load_cell(n) for n in ("mistral-7b.toolbench",
                                       "mixtral-8x22b-12l.toolbench")}
    for name, c in cells.items():
        e2e = {m["name"] for m in c.end_to_end}
        layer = {m.name for m in c.per_layer}
        mixtral = name.startswith("mixtral")
        assert ("latency_p95_s" in e2e) == mixtral
        assert ("latency_p95_s.traced" in layer) != mixtral
        assert {"setup_s", "ttft_p95_ms", "tpot_p50_ms",
                "latency_mean_s"} <= e2e


def _skip_kv_writes(monkeypatch):
    """A step that returns its state unchanged: no KV reaches the pool."""
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "_write_kv", lambda *a, **k: None)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean of the rest in its place."""
    from repro_torch.models import zoo
    real = zoo.top1_logits

    def half(h, w):
        h = h.clone()
        n = h.shape[0]
        if n > 1:
            h[n - n // 2:] = h[:n - n // 2].mean(0)
        return real(h, w)
    monkeypatch.setattr(zoo, "top1_logits", half)


def _altered_tokens(monkeypatch):
    """Every token altered where it is produced."""
    from repro_torch.models import zoo
    real = zoo.top1_logits
    monkeypatch.setattr(zoo, "top1_logits",
                        lambda h, w: (real(h, w) + 1) % w.shape[1])


# one chip: no exchange between chips exists to leave out
@pytest.mark.parametrize("fault", [_skip_kv_writes, _half_batch,
                                   _altered_tokens])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, fault):
    fault(monkeypatch)
    out = _tiny.run(tiny, seed=12)
    assert out["correct"] is False


def _limits(config):
    return json.loads((BENCH_DIR / "configs" / f"{config}.json")
                      .read_text())["check"]["limits"]


@pytest.mark.parametrize("fault", [_skip_kv_writes, _half_batch,
                                   _altered_tokens])
@pytest.mark.parametrize("config,moe", [("mistral-7b", False),
                                        ("mixtral-8x22b-12l", True)])
def test_a_broken_timed_path_fails_each_cells_limits(
        tmp_path, monkeypatch, config, moe, fault):
    """Each fault, judged under a real cell's committed limits (the dense
    or the sparse-expert tiny model beside it), fails a compared number
    itself, not only through failed requests."""
    torch.set_num_threads(2)
    tiny = _tiny.make(tmp_path, moe=moe, limits=_limits(config))
    fault(monkeypatch)
    out = _tiny.run(tiny, seed=12)
    assert out["correct"] is False
    gaps = {k: c for k, c in out["compared"].items()
            if k != "failed_requests"}
    assert set(gaps) == set(_limits(config))
    assert any(c["value"] > c["limit"] for c in gaps.values()), gaps
