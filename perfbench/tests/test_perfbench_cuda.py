"""On the card only (``-m cuda``; each test skips without one): the
device trace that the per-layer readers take their numbers from."""

import time

import pytest
import torch

from benchlib import devtrace
from benchlib.spec import BENCH_DIR, load_module


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


@pytest.mark.cuda
def test_the_slice_lies_on_the_loops_clock():
    _card()
    x = torch.randn(4096, 4096, device="cuda")
    devtrace.warm()
    p = devtrace.DeviceProfiler()
    p.start()
    torch.cuda.synchronize()
    time.sleep(0.05)
    t = time.perf_counter()
    for _ in range(20):
        x = x @ x.T / 64.0
    sl = p.stop()
    ks = sl.kernels()
    assert ks and sl.busy_s > 0
    # the products were launched after t and ran inside the slice
    assert min(s for _, s, _ in ks) > t - 0.002
    assert max(e for _, _, e in ks) <= sl.t1 + 0.002
    assert sl.idle_by_host([("sleep", t - 0.05, t)]).get("sleep", 0) > 0.04


@pytest.mark.cuda
def test_the_roofline_reader_finds_the_paged_kernel_by_name():
    _card()
    from repro_torch.kernels.paged_attention import paged_decode_attention
    mod = load_module(BENCH_DIR / "metrics" / "paged_decode_roofline.py",
                      "roofline_reader")
    B, H, KH, D, PS, P = 4, 32, 8, 128, 16, 16
    q = torch.randn(B, H, D, device="cuda", dtype=torch.bfloat16)
    kp = torch.randn(B * P + 1, PS, KH, D, device="cuda",
                     dtype=torch.bfloat16)
    table = torch.arange(1, B * P + 1, device="cuda",
                         dtype=torch.int32).view(B, P)
    lens = torch.full((B,), P * PS, device="cuda", dtype=torch.int32)
    paged_decode_attention(q, kp, kp, table, lens)
    p = devtrace.DeviceProfiler()
    p.start()
    paged_decode_attention(q, kp, kp, table, lens)
    sl = p.stop()
    names = [n for n, _, _ in sl.kernels()]
    assert any(k in n for n in names for k in mod.KERNELS), names
