"""The benchmark's arithmetic against hand counts: tails, spreads, the
union of device intervals, idle gaps by host span, and the operations
and bytes the readers hold the program to."""

import json
import statistics

import pytest

from benchlib import flops as F
from benchlib import stats
from benchlib.devtrace import DeviceSlice
from benchlib.spec import BENCH_DIR


def test_percentile_is_nearest_rank_with_ten_beyond():
    xs = list(range(1, 201))            # 200 samples
    assert stats.percentile(xs, 95) == 190
    assert stats.beyond(xs, 95) == 10
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 50) == 3
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 11.0, 9.0, 10.5, 9.5, 10.2]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2)


def test_union_and_gaps_by_hand():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 11.0)]
    assert stats.union_length(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert stats.union_length(iv, 1.5, 3.5) == pytest.approx(1.0)
    assert stats.gaps(iv, 0.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    assert stats.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_idle_is_labelled_by_the_host_span_over_it():
    sl = DeviceSlice(0.0, 10.0, [("k", 0.0, 2.0), ("Memcpy HtoD", 2.0, 3.0),
                                 ("k", 6.0, 8.0)])
    assert sl.busy_s == pytest.approx(5.0)
    assert len(sl.kernels()) == 2
    idle = sl.idle_by_host([("step", 3.0, 5.0), ("wait", 8.0, 9.5)])
    assert idle == pytest.approx({"step": 2.0, "other": 1.5, "wait": 1.5})
    assert sl.time_by_name()["k"] == pytest.approx((4.0, 2))


def _dims(name):
    cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    return F.Dims.of(cfg)


def test_active_parameters_by_hand():
    m = _dims("mistral-7b")
    attn = 4096 * 4096 * 2 + 4096 * 1024 * 2
    assert m.layer_active_params == attn + 3 * 4096 * 14336
    # 32 layers: ~6.98e9 besides the embedding and head, as published
    assert 6.9e9 < 32 * m.layer_active_params < 7.0e9
    x = _dims("mixtral-8x22b-12l")
    attn = 6144 * 6144 * 2 + 6144 * 1024 * 2
    assert x.layer_active_params == attn + 6144 * 8 + 2 * 3 * 6144 * 16384


def test_step_flops_and_pairs_by_hand():
    assert F.pairs_of_chunk(0, 3) == 1 + 2 + 3
    assert F.pairs_of_chunk(10, 2) == 11 + 12
    assert F.pairs_of_chunk(7, 5) == sum(7 + i + 1 for i in range(5))
    d = F.Dims(2, 8, 2, 1, 4, 16, 100, 0, 0, 2)
    per_layer = 8 * 2 * 4 * 2 + 8 * 1 * 4 * 2 + 3 * 8 * 16
    got = F.step_flops(d, tokens=5, logit_rows=2, pairs=9)
    assert got == 2 * per_layer * 2 * 5 + 2 * 8 * 100 * 2 + 4 * 4 * 2 * 2 * 9


def test_paged_decode_call_by_hand():
    m = _dims("mistral-7b")
    fl, nb = F.paged_decode_call(m, [100, 300])
    assert fl == 4 * 128 * 32 * 400
    assert nb == 2 * (2 * 2 * 32 * 128 + 2 * 400 * 8 * 128)
    # memory-bound: 1.3 MB at 3.35 TB/s beats 6.6 MFLOP at 989 TFLOP/s
    assert F.bound_seconds(fl, nb) == pytest.approx(nb / F.PEAK_BYTES)
