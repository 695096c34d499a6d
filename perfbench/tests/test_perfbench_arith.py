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
    assert m.active_params == 32 * (attn + 3 * 4096 * 14336)
    # 32 layers: ~6.98e9 besides the embedding and head, as published
    assert 6.9e9 < m.active_params < 7.0e9
    x = _dims("mixtral-8x22b-12l")
    attn = 6144 * 6144 * 2 + 6144 * 1024 * 2
    assert x.active_params == 12 * (attn + 6144 * 8 + 2 * 3 * 6144 * 16384)


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


def test_the_cells_counts_are_as_before():
    """Both cells' operation counts, frozen from the harness before it
    read layer plans."""
    m, x = _dims("mistral-7b"), _dims("mixtral-8x22b-12l")
    assert m.active_params == 32 * 218103808
    assert F.step_flops(m, 4135, 37, 1234567) == 58375959740416.0
    assert F.paged_decode_call(m, [100, 4000]) == (67174400.0, 16826368.0)
    assert x.active_params == 12 * 692109312
    assert F.step_flops(x, 4135, 37, 1234567) == 69063914913792.0
    assert F.paged_decode_call(x, [100, 4000]) == (100761600.0, 16842752.0)
    assert (m.n_attn_layers, m.n_expert_layers, m.n_mamba_layers) == \
        (32, 0, 0)
    assert (x.n_attn_layers, x.n_expert_layers) == (12, 12)


HYBRID = {"num_hidden_layers": 4, "hidden_size": 8, "num_attention_heads": 2,
          "num_key_value_heads": 1, "head_dim": 4, "intermediate_size": 16,
          "moe_intermediate_size": 12, "vocab_size": 100,
          "attn_layer_period": 4, "attn_layer_offset": 2,
          "expert_layer_period": 2, "expert_layer_offset": 1,
          "num_experts": 4, "num_experts_per_tok": 2, "mamba_d_state": 3,
          "mamba_d_conv": 4, "mamba_expand": 2, "mamba_dt_rank": 2,
          "torch_dtype": "bfloat16"}


def test_a_hybrid_steps_operations_by_hand():
    """Layer 2 attends, 0, 1 and 3 are Mamba layers; 1 and 3 route to 2 of
    4 experts 12 wide, 0 and 2 hold a dense FFN 16 wide."""
    d = F.Dims.of(HYBRID)
    assert (d.n_attn_layers, d.n_mamba_layers, d.n_expert_layers) == (1, 3, 2)
    attn = 8 * 2 * 4 * 2 + 8 * 1 * 4 * 2
    ed = 16
    mamba = (8 * 2 * ed            # in_proj
             + 4 * ed              # depthwise conv
             + ed * (2 + 2 * 3)    # x_proj: dt rank, B, C
             + 2 * ed              # dt_proj
             + ed * 8)             # out_proj
    experts = 8 * 4 + 2 * 3 * 8 * 12
    dense = 3 * 8 * 16
    assert d.active_params == attn + 3 * mamba + 2 * experts + 2 * dense
    assert d.scan_ops == 7 * ed * 3
    got = F.step_flops(d, tokens=5, logit_rows=2, pairs=9)
    assert got == (2 * (attn + 3 * mamba + 2 * experts + 2 * dense) * 5
                   + 2 * 8 * 100 * 2        # the head, 2 rows
                   + 4 * 4 * 2 * 1 * 9      # 9 pairs, the one attention
                   + 7 * ed * 3 * 3 * 5)    # the scan, 3 layers, 5 tokens
    # an "auto" dt rank is ceil(hidden / 16)
    assert F.Dims.of(dict(HYBRID, mamba_dt_rank="auto")).dt_rank == 1


def test_a_slice_on_two_cards_averages_their_busy_and_idle_time():
    sl = DeviceSlice(0.0, 10.0, [("k", 0.0, 2.0), ("k", 1.0, 3.0),
                                 ("Memcpy HtoD", 5.0, 6.0)],
                     chips=2, card=[0, 1, 1])
    assert sl.busy_s == pytest.approx((2.0 + 3.0) / 2)
    assert len(sl.kernels()) == 2
    idle = sl.idle_by_host([("step", 0.0, 4.0)])
    # card 0 idle 2-10: 2 s under the step, 6 other; card 1 idle 0-1 and
    # 3-4 under it, 4-5 and 6-10 other
    assert idle == pytest.approx({"step": (2.0 + 2.0) / 2,
                                  "other": (6.0 + 5.0) / 2})
    from benchlib import spans as S
    assert S.idle_by_innermost(sl, [("step", 0.0, 4.0)]) == pytest.approx(
        idle)
    one = DeviceSlice(0.0, 10.0, sl.ops)
    assert one.cards() == [one] and one.busy_s == pytest.approx(4.0)
