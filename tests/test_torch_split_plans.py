"""The host split plans of the port's split-K decode and shared-prefix
decode kernels (src/repro_torch/kernels/{decode,prefix}_attention.py).

A plan is made on the host from shapes, the SM count and the kernel's
tile or residency only: it must cover every key exactly once, never read
the lanes' lengths (they live on the card: reading them back would sync
every call), and spread a batch of one over the card. The kernels that
follow a plan run only on the card (tests/test_torch_cuda.py).
"""

import importlib
import inspect

import pytest

from repro_torch.kernels import paged_attention as PA

# the kernel modules (the package's names of the same spelling are the
# functions)
DA = importlib.import_module("repro_torch.kernels.decode_attention")
PF = importlib.import_module("repro_torch.kernels.prefix_attention")

SMS = 132                                       # an H100 SXM


def _covers_once(n, length, total):
    keys = [t for s in range(n) for t in range(s * length,
                                               min((s + 1) * length, total))]
    return keys == list(range(total)) and (n - 1) * length < total


# (B, KH, S, tile, SMs): full-width decode (smollm-360m bf16 D 64 tiles
# of 64 keys, mistral-7b bf16 D 128 tiles of 32), B 1 and 32, the
# prefix call's suffix, the JAX package's cases, a one-SM card
DEC_PLANS = [(8, 5, 2048, 64, SMS), (8, 8, 8192, 32, SMS),
             (1, 5, 2048, 64, SMS), (1, 8, 8192, 32, SMS),
             (32, 8, 8192, 32, SMS), (32, 8, 256, 32, SMS),
             (32, 5, 256, 64, SMS), (4, 2, 256, 64, SMS),
             (2, 4, 100, 16, SMS), (3, 6, 64, 128, SMS),
             (50, 8, 7 * 64, 64, SMS), (50, 8, 9 * 16, 16, SMS),
             (3, 1, 1000, 64, 1)]


@pytest.mark.parametrize("plan", DEC_PLANS)
def test_decode_split_plan_covers_every_key_once(plan):
    B, KH, S, tile, sms = plan
    n, length = DA.split_plan(B, KH, S, tile, sms)
    assert n >= 1 and length >= tile and length % tile == 0
    assert _covers_once(n, length, S)
    # about BLOCKS_PER_SM blocks an SM at most, never a split past S
    assert n == 1 or n * B * KH <= DA.BLOCKS_PER_SM * sms + B * KH


def test_decode_split_plan_fills_the_card_at_batch_one():
    """B 1 puts at least one block on each of 132 SMs whenever the keys
    have that many tiles; a large batch keeps splits of several tiles."""
    for KH, S, tile in ((5, 2048, 64), (8, 8192, 32), (8, 8192, 16)):
        n, _ = DA.split_plan(1, KH, S, tile, SMS)
        assert n * KH >= SMS
    n, length = DA.split_plan(8, 8, 8192, 32, SMS)
    assert length >= DA.MIN_TILES * 32 and n * 64 >= SMS


@pytest.mark.parametrize("module,fn", [(DA, "decode_attention"),
                                       (PF, "prefix_attention")])
def test_split_plans_read_no_lane_length(module, fn):
    """Neither the plans nor the wrappers read ``lens`` back from the
    card."""
    for plan in (module.split_plan, module.plan_for):
        assert "lens" not in inspect.signature(plan).parameters
    for f in (getattr(module, fn), module._launch):
        src = inspect.getsource(f)
        for call in (".item(", ".tolist(", ".cpu(", "int(lens", "lens.max",
                     "lens.sum"):
            assert call not in src


def test_decode_tiles_are_the_split_kv_stage():
    """The dense decode stages the same 16 KB tiles as paged decode."""
    assert DA.tile_tokens is PA.tile_tokens


# (Sp, KH, rows = B * G, block_k, SMs): full-width smollm-360m (G 3) and
# mistral-7b (G 4) at B 32 and B 1, two row tiles, short prefixes,
# block_k past the prefix, a one-SM card
PRE_PLANS = [(4096, 5, 96, 128, SMS), (4096, 8, 128, 128, SMS),
             (4096, 5, 3, 128, SMS), (4096, 8, 4, 128, SMS),
             (4096, 5, 96, 64, SMS), (1100, 2, 129, 64, SMS),
             (200, 2, 2, 64, SMS), (300, 2, 129, 64, SMS), (63, 3, 24, 64, SMS),
             (1025, 3, 24, 4096, SMS), (1000, 3, 24, 256, SMS),
             (512, 1, 1, 128, 1)]


@pytest.mark.parametrize("plan", PRE_PLANS)
def test_prefix_split_plan_covers_every_key_once(plan):
    Sp, KH, rows, block_k, sms = plan
    n, chunk = PF.split_plan(Sp, KH, rows, block_k, sms)
    assert n >= 1 and chunk % PF.TILE_K == 0
    assert _covers_once(n, chunk, Sp)
    assert n == 1 or chunk >= block_k           # at least block_k keys
    # the f32 partials, written and read back, weigh no more than the
    # prefix's own bytes
    assert n == 1 or 2 * n * rows * 4 <= 4 * Sp


def test_prefix_split_plan_fills_the_card_at_batch_one():
    """B 1: one block on each of the 132 SMs at full widths, where the
    partials are a few rows; at B 32 the partial bytes cap the splits."""
    for KH, G in ((5, 3), (8, 4)):
        for block_k in (64, 128):
            n, _ = PF.split_plan(4096, KH, G, block_k, SMS)
            assert n * KH >= SMS
    assert PF.split_plan(4096, 5, 96, 128, SMS)[0] * 5 < SMS
