"""The port's paged decode attention against the JAX package.

On the CPU the wrapper runs its plain PyTorch version, which must match
the Pallas kernel (interpret mode) and the JAX gather path on the same
inputs, made from a seed with numpy. The CUDA kernel itself runs only on
a card: its tests are in tests/test_torch_cuda.py.

Tolerances: float32 inputs, atol 3e-5 / rtol 1e-4 (the JAX package's
own kernel tolerance; the two sides sum in different orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_decode_attention as jpaged
from repro.models.attention import paged_attention as jgather
from repro_torch.kernels import build, ref
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels.checks import HEAD_DIMS
from repro_torch.kernels.decode_attention import lse_merge
from repro_torch.kernels.flash_attention import head_group

torch.set_num_threads(1)

# the JAX package's own cases (tests/test_kernels.py): (B, H, KH, page,
# P, n_pages, D) and the ragged page-boundary lens
PAGED_CASES = [(3, 8, 2, 16, 4, 32, 64), (2, 4, 4, 8, 6, 24, 32),
               (1, 16, 8, 32, 3, 16, 128)]
PAGED_EDGE_LENS = [[3, 16, 21, 64], [1, 8, 48, 63], [16, 32, 5, 17]]


def _inputs(B, H, KH, page, P, n_pages, D, seed, lens=None):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((n_pages, page, KH, D)).astype(np.float32)
    v = rng.standard_normal((n_pages, page, KH, D)).astype(np.float32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    pt = np.stack([rng.choice(n_pages, P, replace=False)
                   for _ in range(B)]).astype(np.int32)
    if lens is None:
        lens = rng.integers(1, page * P + 1, B)
    return q, k, v, pt, np.asarray(lens, np.int32)


def _port(q, k, v, pt, lens):
    return PA.paged_decode_attention(*(torch.from_numpy(a) for a in
                                       (q, k, v, pt, lens))).numpy()


@pytest.mark.parametrize("case", PAGED_CASES)
def test_plain_matches_pallas_kernel(case):
    q, k, v, pt, lens = _inputs(*case, seed=case[0])
    before = PA.paged_decode_attention.launches
    got = _port(q, k, v, pt, lens)
    assert PA.paged_decode_attention.launches == before, \
        "a CPU tensor must take the plain version, never count a launch"
    exp = jpaged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 jnp.asarray(pt), jnp.asarray(lens), interpret=True)
    np.testing.assert_allclose(got, np.asarray(exp), atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("lens", PAGED_EDGE_LENS)
def test_plain_matches_pallas_kernel_ragged_lens(lens):
    q, k, v, pt, lens = _inputs(len(lens), 8, 2, 16, 4, 24, 32, seed=7,
                                lens=lens)
    got = _port(q, k, v, pt, lens)
    exp = jpaged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 jnp.asarray(pt), jnp.asarray(lens), interpret=True)
    np.testing.assert_allclose(got, np.asarray(exp), atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("case", PAGED_CASES)
def test_plain_matches_jax_gather_path(case):
    """The JAX engine's CPU path (models/attention.paged_attention
    'gather'). No lane has len 0, where the two references differ."""
    q, k, v, pt, lens = _inputs(*case, seed=11 + case[0])
    got = _port(q, k, v, pt, lens)
    exp = jgather(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.asarray(pt), jnp.asarray(lens), impl="gather")
    np.testing.assert_allclose(got, np.asarray(exp), atol=3e-5, rtol=1e-4)


def test_plain_len_zero_follows_pallas_kernel():
    """A fully masked lane returns 0, as the Pallas kernel does (the JAX
    gather path returns the mean of V there; the engine never asks)."""
    q, k, v, pt, lens = _inputs(2, 4, 2, 8, 3, 12, 16, seed=3,
                                lens=[0, 5])
    got = _port(q, k, v, pt, lens)
    exp = jpaged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 jnp.asarray(pt), jnp.asarray(lens), interpret=True)
    np.testing.assert_allclose(got, np.asarray(exp), atol=3e-5, rtol=1e-4)
    assert not got[0].any()


# (B, KH, P, PS, tile, SMs): the main-path shapes (smollm, 132 SMs), a
# table shorter than a tile, pages longer than a tile, many lanes
PLANS = [(1, 5, 128, 16, 64, 132), (8, 5, 128, 16, 64, 132),
         (32, 5, 128, 16, 64, 132), (8, 5, 64, 16, 64, 132),
         (2, 2, 3, 8, 64, 132), (1, 8, 40, 32, 16, 132),
         (256, 8, 512, 16, 256, 132), (3, 1, 7, 16, 48, 1)]


@pytest.mark.parametrize("plan", PLANS)
def test_split_plan_covers_every_page_once(plan):
    B, KH, P, PS, tile, sms = plan
    n, pps = PA.split_plan(B, KH, P, PS, tile, sms)
    assert n >= 1 and pps >= 1
    covered = [p for s in range(n)
               for p in range(s * pps, min((s + 1) * pps, P))]
    assert covered == list(range(P))         # every page once, in order
    assert (n - 1) * pps < P                 # no split past the table
    assert pps * PS >= min(tile, P * PS)     # at least one tile (or all)
    assert n <= max(1, -(-PA.BLOCKS_PER_SM * sms // (B * KH)))


def test_split_plan_fills_the_card_at_small_batch():
    """B 1 spreads a long row over many blocks; a large batch needs no
    split at all."""
    n1, _ = PA.split_plan(1, 5, 128, 16, 64, 132)
    assert n1 * 5 >= 132
    assert PA.split_plan(256, 8, 512, 16, 64, 132)[0] == 1


def test_split_plan_reads_no_lane_length():
    """The plan is made on the host from shapes only: neither it nor the
    wrapper may read ``lens`` back from the card (a sync every layer)."""
    import inspect
    assert "lens" not in inspect.signature(PA.split_plan).parameters
    assert "lens" not in inspect.signature(PA.plan_for).parameters
    src = inspect.getsource(PA.paged_decode_attention)
    for call in (".item(", ".tolist(", ".cpu(", "int(lens", "lens.max"):
        assert call not in src


def test_tile_tokens_fill_a_16kb_stage():
    for dtype in (torch.float32, torch.bfloat16):
        for D in HEAD_DIMS:
            t = PA.tile_tokens(dtype, D)
            item = torch.empty((), dtype=dtype).element_size()
            assert t * D * item * 2 == 16384 and t % 16 == 0


@pytest.mark.parametrize("G,want", [(1, 1), (2, 2), (3, 3), (4, 4), (8, 4)])
def test_flash_head_group(G, want):
    """A bf16 flash block holds all G heads of a KV head up to 4, and a
    group of 4 for G 8 (two blocks per KV head)."""
    assert head_group(G) == want and G % head_group(G) == 0


def _paged_partials_plain(q, k_pages, v_pages, page_table, lens,
                         n_splits: int, pps: int):
    """The paged kernel's split partials in plain PyTorch, f32: split s
    covers the tokens of table entries [s * pps, (s + 1) * pps) of each
    lane.
    Returns acc [B, KH, n_splits, G, D] (unnormalised), m and l [B, KH,
    n_splits, G, 1] (m -inf, l 0, acc 0 for a split with no valid token),
    which ``decode_attention.lse_merge`` combines into
    ``paged_decode_attention_plain``'s result."""
    B, H, D = q.shape
    _, PS, KH, _ = k_pages.shape
    P = page_table.shape[1]
    G = H // KH
    pad = n_splits * pps - P
    idx = torch.nn.functional.pad(page_table.long(), (0, pad))
    S = n_splits * pps * PS
    k = k_pages[idx].reshape(B, n_splits, pps * PS, KH, D).float()
    v = v_pages[idx].reshape(B, n_splits, pps * PS, KH, D).float()
    qg = q.reshape(B, KH, G, D).float()
    s = torch.einsum("bhgd,bnkhd->bhngk", qg, k) * (D ** -0.5)
    pos = torch.arange(S, device=q.device).reshape(n_splits, pps * PS)
    valid = torch.clamp(lens.to(q.device).long(), 0, P * PS)
    mask = pos[None] < valid[:, None, None]              # [B, ns, chunk]
    s = s.masked_fill(~mask[:, None, :, None, :], float("-inf"))
    m = s.amax(-1, keepdim=True)
    m_safe = torch.where(m == float("-inf"), 0.0, m)
    p = torch.exp(s - m_safe)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhngk,bnkhd->bhngd", p, v)
    return acc, m, l


def _split_cases():
    for case in PAGED_CASES:
        P = case[4]
        for n in (1, 2, P):
            yield case, None, n
    for lens in PAGED_EDGE_LENS:
        for n in (2, 4):
            yield (len(lens), 8, 2, 16, 4, 24, 32), lens, n


@pytest.mark.parametrize("case,lens,n", list(_split_cases()))
def test_split_and_merge_matches_pallas_kernel(case, lens, n):
    """The kernel's arithmetic (whole-page splits, f32 partials, one
    lse_merge), emulated in plain PyTorch at several n_splits, against the
    Pallas kernel in interpret mode."""
    q, k, v, pt, lens = _inputs(*case, seed=case[0] + n, lens=lens)
    P = pt.shape[1]
    pps = -(-P // n)
    n_splits = -(-P // pps)
    qt = torch.from_numpy(q)
    got = lse_merge(*_paged_partials_plain(
        qt, *(torch.from_numpy(a) for a in (k, v, pt, lens)), n_splits,
        pps)).reshape(qt.shape).numpy()
    exp = jpaged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 jnp.asarray(pt), jnp.asarray(lens), interpret=True)
    np.testing.assert_allclose(got, np.asarray(exp), atol=3e-5, rtol=1e-4)


def test_decode_attention_ref_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((3, 6, 32)).astype(np.float32)
    k = rng.standard_normal((3, 2, 40, 32)).astype(np.float32)
    v = rng.standard_normal((3, 2, 40, 32)).astype(np.float32)
    lens = np.array([1, 17, 40], np.int32)
    got = ref.decode_attention_ref(*(torch.from_numpy(a)
                                     for a in (q, k, v, lens))).numpy()
    exp = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(lens))
    np.testing.assert_allclose(got, np.asarray(exp), atol=3e-5, rtol=1e-4)


def _cpu_case(dtype=torch.float32, G=2, D=32, pt_dtype=torch.int32):
    B, KH, PS, n = 2, 2, 8, 6
    q = torch.zeros(B, G * KH, D, dtype=dtype)
    k = torch.zeros(n, PS, KH, D, dtype=dtype)
    pt = torch.zeros(B, 3, dtype=pt_dtype)
    lens = torch.ones(B, dtype=torch.int32)
    return q, k, k.clone(), pt, lens


@pytest.mark.parametrize("bad,err", [
    (dict(dtype=torch.float16), TypeError),
    (dict(pt_dtype=torch.int64), TypeError),
    (dict(G=5), ValueError),
    (dict(D=48), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        PA._check_cuda(*_cpu_case(**bad))


def test_wrapper_rejects_non_contiguous_and_foreign_devices():
    q, k, v, pt, lens = _cpu_case()
    PA._check_cuda(q, k, v, pt, lens)                   # accepted as is
    with pytest.raises(ValueError):
        PA._check_cuda(q, k.transpose(0, 1).contiguous().transpose(0, 1),
                       v, pt, lens)
    with pytest.raises(ValueError):                     # devices differ
        PA._check_cuda(q, k.to("meta"), v, pt, lens)
    # meta tensors (shapes only): an empty output of the kernel's shape
    out = PA.paged_decode_attention(*(t.to("meta") for t in
                                      (q, k, v, pt, lens)))
    assert out.device.type == "meta" and out.shape == q.shape


def test_build_rebuilds_when_the_source_changes(tmp_path, monkeypatch):
    """The library name carries the source hash; nvcc is not needed to
    name it."""
    assert "paged_attention" in build.sources()
    before = build.library_path("paged_attention")
    assert before.parent == build.BUILD_DIR
    src = tmp_path / "paged_attention.cu"
    src.write_text((build.CSRC / "paged_attention.cu").read_text() + "\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.library_path("paged_attention") != before


def test_build_rebuilds_when_a_shared_header_changes(tmp_path, monkeypatch):
    """A .cu may include any csrc/*.cuh: editing a header renames every
    library, so a stale one is never loaded."""
    for f in list(build.CSRC.glob("*.cu")) + list(build.CSRC.glob("*.cuh")):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    assert (tmp_path / "common.cuh").exists()
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build.library_path(n) for n in build.sources()}
    assert set(before) >= {"paged_attention", "decode_attention",
                           "prefix_attention", "flash_attention"}
    header = tmp_path / "common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in build.sources()}
    assert all(after[n] != before[n] for n in before)
    (tmp_path / "unrelated.cuh").write_text("// new header\n")
    assert all(build.library_path(n) != after[n] for n in after)
