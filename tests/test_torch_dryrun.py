"""The port's dry-run and roofline analysis against the JAX package's, on
the CPU, compiling no JAX function:

(a) ``cell_list`` and the ``--list`` text, line for line;
(b) for every runnable cell on the production meshes (one pod, two pods,
    and the expert-axis mesh), the PartitionSpecs of every argument and
    output (parameters under train_policy / serve_policy, batch, cache,
    int8-moment scales), ``pick_grad_accum``, the ``quant_moments``
    decision, the activation layout the reference pins, and the
    per-device argument and output bytes, against the reference's own
    ``build_cell``. The reference builds its cells on 256 or 512 real
    devices; here its ``jax.make_mesh`` returns a shape-only mesh (as
    tests/test_sharding_policy.py's FakeMesh), ``NamedSharding`` a
    record of (mesh, spec) and ``jax.jit`` a record of its shardings,
    so its build_cell runs unchanged and nothing is lowered or
    compiled;
(c) ``abstract()``, ``axes()`` and ``n_params`` of all 12 configs, and
    ``model_flops_for`` of every cell;
(d) ``_wire_bytes`` and ``roofline_from_record`` by hand with the H100
    constants;
(e) counting: the meta count of a step equals its CPU count exactly on
    reduced smollm, mixtral (half-expert on a (2, 4) CPU mesh, routed
    decode), rwkv6 and whisper; the routed MoE's T x K identity against
    its executed count; the kernels' formulas against hand counts, and
    the wrappers' meta branches; the analytic collective rule by hand on
    one cell;
(f) the CLI and ``roofline_report`` on one cell into a temporary dir.

The reference's dry-run module sets XLA_FLAGS in os.environ when
imported; it is imported here with the environment restored.
"""

import contextlib
import dataclasses
import importlib
import json
import math
import os
import sys
import types

import jax
import pytest
import torch

_ENV = dict(os.environ)
import repro.launch.dryrun as jdry  # noqa: E402
os.environ.clear()
os.environ.update(_ENV)

from repro.analysis.roofline import model_flops_for as j_model_flops  # noqa
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.models.spec import abstract_params as j_abstract  # noqa: E402

from repro_torch.analysis import counting, roofline as R  # noqa: E402
from repro_torch.analysis import roofline_report  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, reduced  # noqa
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402

# the kernel modules (the package's names of the same spelling are the
# functions)
tdec, tflash, tpaged, tprefix = (
    importlib.import_module(f"repro_torch.kernels.{m}")
    for m in ("decode_attention", "flash_attention", "paged_attention",
              "prefix_attention"))

torch.set_num_threads(1)

RUNNABLE = [(a, s) for a, s, ok, _ in jdry.cell_list() if ok]
MESHES = {"pod1": dict(multi_pod=False),
          "pod2": dict(multi_pod=True),
          "expert": dict(multi_pod=False, overrides={"expert_mesh": True}),
          "expert_pod2": dict(multi_pod=True,
                              overrides={"expert_mesh": True})}


# ---------------------------------------------------------------------------
# the reference's build_cell on a shape-only mesh
# ---------------------------------------------------------------------------

class FakeMesh:
    """Shape-only stand-in for a jax Mesh (tests/test_sharding_policy.py)."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


class FakeSharding:
    """What NamedSharding(mesh, spec) was asked for."""
    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


def _fake_jit(fn, in_shardings=None, out_shardings=None, donate_argnums=()):
    return types.SimpleNamespace(fn=fn, in_shardings=in_shardings,
                                 out_shardings=out_shardings)


def _reset_reference_layout():
    jcommon.set_mesh(None)
    jcommon.set_batch_axes(None)
    jcommon.set_seq_axes(None)
    jcommon.set_head_axes(None)
    jcommon.set_expert_axes(None)
    jcommon.set_ep_decode(False)


@contextlib.contextmanager
def _shape_only_reference():
    mp = pytest.MonkeyPatch()
    mp.setattr(jmesh, "jax", types.SimpleNamespace(
        make_mesh=lambda shape, axes: FakeMesh(dict(zip(axes, shape)))))
    mp.setattr(jdry, "NamedSharding", FakeSharding)
    mp.setattr(jsh, "NamedSharding", FakeSharding)
    mp.setattr(jdry, "jax", types.SimpleNamespace(
        jit=_fake_jit, tree=jax.tree, ShapeDtypeStruct=jax.ShapeDtypeStruct))
    try:
        yield
    finally:
        mp.undo()
        _reset_reference_layout()


def _reference_cell(arch, shape, multi_pod, overrides=None):
    """(mesh, jit record, abstract args, extra, layout) of the reference's
    build_cell for this cell."""
    with _shape_only_reference():
        mesh, fn, args, extra = jdry.build_cell(arch, shape, multi_pod,
                                                overrides)
        layout = dict(batch=jcommon._BATCH_AXES, seq=jcommon._SEQ_AXES,
                      seq_size=jcommon._SEQ_SIZE, head=jcommon._HEAD_AXES,
                      head_size=jcommon._HEAD_SIZE,
                      expert=jcommon._EXPERT_AXES,
                      ep_decode=jcommon.ep_decode())
    return mesh, fn, args, extra, layout


def _specs(tree):
    """The reference's sharding tree as the port's PartitionSpec tuples."""
    if isinstance(tree, FakeSharding):
        return tuple(tree.spec)
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_specs(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return {f.name: _specs(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    assert tree is None, type(tree)
    return None


def _is_pspec(t):
    return isinstance(t, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(x, str) for x in e))
        for e in t)


def _port_specs(tree):
    """The port's PartitionSpec trees in ``_specs``'s form."""
    if _is_pspec(tree):
        return tree
    if isinstance(tree, dict):
        return {k: _port_specs(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_port_specs(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return {f.name: _port_specs(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    assert tree is None, type(tree)
    return None


def _reference_bytes(args, shardings, mesh):
    """One device's bytes of the reference's abstract args under its
    shardings: each leaf's bytes divided by the sizes of the mesh axes
    its spec names."""
    leaves = jax.tree.leaves(args)
    shs = jax.tree.leaves(shardings,
                          is_leaf=lambda x: isinstance(x, FakeSharding))
    assert len(leaves) == len(shs)
    total = 0
    for a, sh in zip(leaves, shs):
        n = math.prod(a.shape) * a.dtype.itemsize
        for e in tuple(sh.spec):
            for ax in ((e,) if isinstance(e, str) else (e or ())):
                n //= mesh.shape[ax]
        total += n
    return total


# ---------------------------------------------------------------------------
# (a) the cells and --list
# ---------------------------------------------------------------------------

def test_cell_list_and_list_text_match_the_reference(capsys, monkeypatch):
    assert tdry.cell_list() == jdry.cell_list()
    monkeypatch.setattr(sys, "argv", ["dryrun", "--list"])
    assert jdry.main() == 0
    want = capsys.readouterr().out
    assert tdry.main(["--list"]) == 0
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert sum(" RUN" in line for line in got.splitlines()) == 33
    assert sum(" SKIP: " in line for line in got.splitlines()) == 7


def test_production_meshes_match_the_reference():
    with _shape_only_reference():
        for mp in (False, True):
            for ea in (False, True):
                j = jmesh.make_production_mesh(multi_pod=mp, expert_axis=ea)
                t = tmesh.make_production_mesh(multi_pod=mp, expert_axis=ea)
                assert list(t.shape.items()) == list(j.shape.items())
                assert tuple(t.shape) == j.axis_names
                assert t.size == math.prod(j.shape.values())
                assert all(d.type == "meta" for d in t.devices)
                assert tmesh.data_axes(t) == jmesh.data_axes(j)
                for axes in (("pod", "data"), "model", ("data", "model")):
                    if all(a in j.shape for a in jsh._norm(axes)):
                        assert tmesh.axis_size(t, axes) == \
                            jmesh.axis_size(j, axes)
    # the existing ("data", "model") meshes keep their shapes
    assert tmesh.make_mesh(2, 4, platform="cpu").shape == {"data": 2,
                                                           "model": 4}
    assert tmesh.make_serve_mesh(3, platform="cpu").shape == {"data": 1,
                                                              "model": 3}
    host = tmesh.make_host_mesh(3)
    assert host.shape == {"data": 3, "model": 1}
    assert {d.type for d in host.devices} == {"cpu"}
    with pytest.raises(ValueError):
        tmesh.named_mesh({"data": 2, "model": 2}, ["cpu"] * 3)


# ---------------------------------------------------------------------------
# (b) every cell's specs, decisions and bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", RUNNABLE)
def test_cell_specs_and_bytes_match_the_reference(arch, shape, mesh_name):
    kw = MESHES[mesh_name]
    jm, fn, jargs, jextra, jlay = _reference_cell(arch, shape, **kw)
    cell = tdry.build_cell(arch, shape, **kw)
    assert dict(cell.mesh.shape) == jm.shape
    assert cell.extra == jextra
    # the arguments' PartitionSpecs, leaf by leaf
    assert _port_specs(cell.arg_pspecs) == _specs(fn.in_shardings)
    if fn.out_shardings is not None:
        assert _port_specs(cell.out_pspecs) == _specs(fn.out_shardings)
    # per-device bytes: the port's own arithmetic against the reference's
    # specs over the reference's abstract arguments
    assert tdry.tree_shard_bytes(cell.args, cell.arg_pspecs, cell.mesh) == \
        _reference_bytes(jargs, fn.in_shardings, jm)
    # the decisions and the layout the reference pins
    cfg, sh = JARCHS[arch], JSHAPES[shape]
    if sh.kind == "train":
        assert tdry.pick_grad_accum(ARCHS[arch], SHAPES[shape], cell.mesh) \
            == jdry.pick_grad_accum(cfg, sh, jm) == jextra["grad_accum"]
    lay = cell.layout
    for k in ("batch", "seq", "head", "expert", "ep_decode"):
        assert lay[k] == jlay[k], k
    if jlay["seq"] is not None:
        assert lay["seq_size"] == jlay["seq_size"]
    if jlay["head"] is not None:
        assert lay["head_size"] == jlay["head_size"]
    # inside a step the port's models see the mesh and the decode switch
    with tdry.applied(lay):
        assert tcommon.get_mesh() is cell.mesh
        assert tcommon.ep_decode() == jlay["ep_decode"]
    assert tcommon.get_mesh() is None and not tcommon.ep_decode()


def test_q8_scale_rule_matches_the_reference():
    """The int8 moments' scale spec: the reference's inline q8_sharding
    rule through a quant_moments cell (grok-1-314b train_4k takes it by
    its own decision), leaf by leaf (checked in the cell test), and the
    rule on its own."""
    jm, fn, _, jextra, _ = _reference_cell("grok-1-314b", "train_4k", False)
    assert jextra["quant_moments"]
    m = fn.in_shardings[0].opt["m"]
    cell = tdry.build_cell("grok-1-314b", "train_4k")
    got = cell.arg_pspecs[0].opt["m"]
    n = 0
    for path, ref in _flat(_specs(m)).items():
        assert _get(got, path) == ref
        n += 1
    assert n > 0
    from repro_torch.launch.sharding import q8_scale_pspec
    assert q8_scale_pspec(("data", "model"), 2) == ("data",)
    assert q8_scale_pspec(("data",), 2) == ("data",)
    assert q8_scale_pspec((), 1) == ()


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# (c) parameters and model FLOPs
# ---------------------------------------------------------------------------

def _dtype_name(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_axes_and_counts_match_the_reference(arch):
    japi, tapi = jzoo.build(JARCHS[arch]), tzoo.build(ARCHS[arch])
    want = _flat(j_abstract(japi.specs))
    got = _flat(tapi.abstract())
    assert set(got) == set(want)
    for k, s in want.items():
        t = got[k]
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(s.shape), k
        assert _dtype_name(t.dtype) == str(s.dtype), k
    assert _flat(tapi.axes()) == _flat(japi.axes())
    assert tapi.n_params == japi.n_params
    assert tapi.n_active_params == japi.n_active_params


@pytest.mark.parametrize("arch,shape", RUNNABLE)
def test_model_flops_match_the_reference(arch, shape):
    japi, tapi = jzoo.build(JARCHS[arch]), tzoo.build(ARCHS[arch])
    assert R.model_flops_for(ARCHS[arch], SHAPES[shape],
                             tapi.n_active_params) == \
        j_model_flops(JARCHS[arch], JSHAPES[shape], japi.n_active_params)


# ---------------------------------------------------------------------------
# (d) the roofline by hand
# ---------------------------------------------------------------------------

def test_wire_bytes_by_hand():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 450e9)
    f = 15 / 16
    assert R._wire_bytes("all-reduce", 1600.0) == 2 * f * 1600.0
    assert R._wire_bytes("all-gather", 1600.0) == f * 1600.0
    assert R._wire_bytes("reduce-scatter", 1600.0) == f * 1600.0 * 16
    assert R._wire_bytes("all-to-all", 1600.0) == f * 1600.0
    assert R._wire_bytes("collective-permute", 1600.0) == 1600.0
    assert R._wire_bytes("all-reduce", 100.0, axis_n=4) == 2 * 0.75 * 100.0


def test_roofline_from_record_by_hand():
    rec = {"devices": 4, "count": {
        "dot_flops": 2 * 989e12, "dot_bytes": 3.35e12,
        "collective_bytes": {"all-reduce": 240e9, "all-gather": 480e9}}}
    t = R.roofline_from_record(rec, model_flops=4 * 989e12)
    assert t.compute_s == 2.0
    assert t.memory_s == 1.0
    wire = 2 * (15 / 16) * 240e9 + (15 / 16) * 480e9
    assert t.collective_wire_bytes == wire
    assert t.collective_s == wire / 450e9
    assert t.dominant == "compute" and t.step_time_s == 2.0
    assert t.roofline_fraction == 1.0
    assert t.useful_ratio == (4 * 989e12) / (2 * 989e12 * 4)
    rec["count"]["dot_bytes"] = 3 * 3.35e12
    t = R.roofline_from_record(rec)
    assert t.dominant == "memory" and t.roofline_fraction == 2.0 / 3.0
    assert t.useful_ratio == 0.0


# ---------------------------------------------------------------------------
# (e) counting
# ---------------------------------------------------------------------------

def _f32(arch, **kw):
    return dataclasses.replace(reduced(ARCHS[arch], **kw), dtype="float32")


SMALL = {"train": ShapeSpec("train_cut", 32, 4, "train"),
         "prefill": ShapeSpec("prefill_cut", 64, 2, "prefill"),
         "decode": ShapeSpec("decode_cut", 64, 4, "decode")}

COUNT_CASES = [
    # (arch, config overrides, kind, mesh): half-expert MoE on train and
    # prefill at tp 4 (4 experts); routed decode where tp does not divide
    # the expert count (6 experts at tp 4)
    ("smollm-360m", {}, "train", (1, 1)),
    ("smollm-360m", {}, "prefill", (2, 4)),
    ("smollm-360m", {}, "decode", (2, 4)),
    ("mixtral-8x22b", {}, "train", (2, 4)),
    ("mixtral-8x22b", {}, "prefill", (2, 4)),
    ("mixtral-8x22b", {"n_experts": 6}, "decode", (2, 4)),
    ("rwkv6-7b", {}, "train", (2, 4)),
    ("rwkv6-7b", {}, "decode", (2, 4)),
    ("whisper-tiny", {}, "train", (2, 4)),
    ("whisper-tiny", {}, "decode", (2, 4)),
]


def _count(cfg, kind, dims, dev):
    mesh = tmesh.make_mesh(*dims, [dev] * (dims[0] * dims[1]))
    cell = tdry.build_cell(cfg, SMALL[kind], mesh=mesh, device=dev)
    tlayers.MOE_STATS.update(calls=0, host_syncs=0, expert_products=0)
    c = tdry.count_cell(cell)
    return cell, c, dict(tlayers.MOE_STATS)


@pytest.mark.parametrize("arch,kw,kind,dims", COUNT_CASES)
def test_meta_count_equals_the_cpu_count(arch, kw, kind, dims):
    cfg = _f32(arch, **kw)
    cell, meta, _ = _count(cfg, kind, dims, "meta")
    _, cpu, stats = _count(cfg, kind, dims, "cpu")
    assert meta.dot_flops == cpu.dot_flops > 0
    assert meta.collective_bytes == cpu.collective_bytes
    assert meta.collective_counts == cpu.collective_counts
    assert meta.kernels == cpu.kernels
    routed = stats["calls"]
    if cell.cfg.moe_impl == "halfexpert":
        assert meta.collective_counts["all-gather"] > 0
    if not routed:
        assert meta.dot_bytes == cpu.dot_bytes
        assert meta.dots == cpu.dots
        return
    # routed MoE: every product's FLOPs by the T x K identity; on meta
    # each call counts min(E, T x K) experts' weights, the CPU only the
    # experts the routing hit
    T, K, E = SMALL[kind].global_batch, cfg.experts_per_token, cfg.n_experts
    hit_assumed = min(E, T * K)
    missed = routed * hit_assumed - stats["expert_products"]
    d, f = cfg.d_model, cfg.d_ff
    assert meta.dot_bytes - cpu.dot_bytes == missed * 3 * d * f * 4
    assert meta.dots - cpu.dots == 3 * missed


def test_decode_kernel_is_counted_in_the_decode_cell():
    cfg = _f32("smollm-360m")
    _, c, _ = _count(cfg, "decode", (1, 1), "cpu")
    S, B = SMALL["decode"].seq_len, SMALL["decode"].global_batch
    k = c.kernels["decode_attention"]
    assert k["calls"] == cfg.n_layers
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    assert k["flops"] == cfg.n_layers * 4 * B * S * H * D
    assert k["bytes"] == cfg.n_layers * (B * S * KH * D * 2 * 4
                                         + 2 * B * H * D * 4 + B * 4)


def _tp_slot_decode(dev, tp):
    """One tensor-parallel paged decode on a slot-wise pool (the
    attention of a TP serve step, ``models/attention.py``
    ``paged_attention_tp``): q heads split over tp shards, each shard
    holding PS / tp slots of every page; full lanes. Returns the counter
    and the shards' outputs."""
    from repro_torch.launch import sharding as tsh
    from repro_torch.models import attention as tatt
    g = torch.Generator().manual_seed(7)
    B, H, KH, D, PS, P, N = 3, 8, 2, 64, 16, 32, 80
    q = torch.randn(B, H, D, generator=g)
    kp, vp = (torch.randn(N, PS, KH, D, generator=g) for _ in range(2))
    pt = torch.randint(1, N, (B, P), generator=g, dtype=torch.int32)
    lens = torch.full((B,), P * PS, dtype=torch.int32)
    plan = tsh.ShardPlan(mesh=tmesh.make_mesh(1, tp, [dev] * tp),
                         heads=True, kv_heads=False, ff=True, vocab=True,
                         pool="slot", n_pages=N, page_size=PS)
    sl, hs = PS // tp, H // tp
    qs = [q[:, s * hs:(s + 1) * hs].contiguous().to(dev) for s in range(tp)]
    pages = [{n: t[:, s * sl:(s + 1) * sl].contiguous().to(dev)
              for n, t in (("k", kp), ("v", vp))} for s in range(tp)]
    with counting.Counter() as c:
        out = tatt.paged_attention_tp(qs, pages, [pt.to(dev)] * tp,
                                      [lens.to(dev)] * tp, plan, H)
    return c, out


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_slot_decode_count_is_the_same_on_meta_and_cpu(tp):
    """The slot-wise TP decode's partials and merge are charged one f32
    slot a shard whatever the split count, so the count of the step
    is the same on meta and on the CPU."""
    meta, mout = _tp_slot_decode("meta", tp)
    cpu, out = _tp_slot_decode("cpu", tp)
    assert [o.shape for o in mout] == [o.shape for o in out]
    assert (meta.dot_flops, meta.dot_bytes, meta.kernels) == \
        (cpu.dot_flops, cpu.dot_bytes, cpu.kernels)
    assert meta.collective_bytes == cpu.collective_bytes
    assert meta.collective_counts == cpu.collective_counts
    B, H, KH, D = 3, 8, 2, 64
    assert cpu.kernels["paged_decode_partials"]["calls"] == tp
    assert cpu.kernels["lse_merge_partials"] == {
        "calls": 1, "flops": 0,
        "bytes": B * KH * tp * (H // KH) * (D + 2) * 4 + B * H * D * 4}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_routed_identity_equals_the_executed_count(seed):
    cfg = _f32("mixtral-8x22b", n_experts=6)
    g = torch.Generator().manual_seed(seed)
    E, d, f, K = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.experts_per_token
    p = {"router": torch.randn(d, E, generator=g),
         "wg": torch.randn(E, d, f, generator=g) * 0.1,
         "wu": torch.randn(E, d, f, generator=g) * 0.1,
         "wd": torch.randn(E, f, d, generator=g) * 0.1}
    T = 5
    x = torch.randn(T, d, generator=g)
    tlayers.MOE_STATS.update(calls=0, host_syncs=0, expert_products=0)
    with counting.Counter() as cpu:
        tlayers._routed(p, cfg, x)
    hit = tlayers.MOE_STATS["expert_products"]
    router = 2 * T * d * E, (T * d + d * E + T * E) * 4
    flops, bytes_ = counting.routed_cost(T, K, d, f, hit, torch.float32,
                                         torch.float32)
    assert cpu.dot_flops == router[0] + flops
    assert cpu.dot_bytes == router[1] + bytes_
    meta_p = {k: v.to("meta") for k, v in p.items()}
    with counting.Counter() as meta:
        out = tlayers._routed(meta_p, cfg, x.to("meta"))
    assert out.shape == (T, d) and out.device.type == "meta"
    assert tlayers.MOE_STATS["calls"] == 1          # meta left it alone
    flops_m, bytes_m = counting.routed_cost(T, K, d, f, min(E, T * K),
                                            torch.float32, torch.float32)
    assert meta.dot_flops == router[0] + flops_m == cpu.dot_flops
    assert meta.dot_bytes == router[1] + bytes_m
    assert meta.dot_bytes - cpu.dot_bytes == \
        (min(E, T * K) - hit) * 3 * d * f * 4


def test_kernel_formulas_by_hand():
    B, H, KH, S, D = 3, 6, 2, 40, 16
    q = torch.zeros(B, H, D, dtype=torch.bfloat16)
    k = torch.zeros(B, KH, S, D, dtype=torch.bfloat16)
    lens = torch.tensor([40, 7, 0], dtype=torch.int32)
    assert counting.decode_cost(q, k, lens) == (
        4 * 47 * H * D, 47 * KH * D * 2 * 2 + 2 * B * H * D * 2 + B * 4)
    # on meta every lane counts as full
    assert counting.decode_cost(q.to("meta"), k.to("meta"),
                                lens.to("meta"))[0] == 4 * 3 * S * H * D
    PS, P = 8, 6
    pages = torch.zeros(20, PS, KH, D, dtype=torch.bfloat16)
    table = torch.zeros(B, P, dtype=torch.int32)
    assert counting.paged_cost(q, pages, table, lens) == (
        4 * 47 * H * D,
        47 * KH * D * 2 * 2 + 2 * B * H * D * 2 + B * 4 + (5 + 1 + 0) * 4)
    kp = torch.zeros(KH, 24, D, dtype=torch.bfloat16)
    assert counting.prefix_cost(q, kp) == (
        4 * H * D * B * 24, 2 * KH * 24 * D * 2 + B * H * D * 2
        + B * H * (D + 2) * 4)
    ks = torch.zeros(B, KH, 9, D, dtype=torch.bfloat16)
    assert counting.prefix_cost(q, kp, ks, lens) == (
        4 * H * D * (B * 24 + 9 + 7 + 0),
        2 * KH * 24 * D * 2 + 16 * KH * D * 2 * 2 + 2 * B * H * D * 2
        + B * 4)
    assert counting.visible_pairs(4, 4, True, 0) == 10
    assert counting.visible_pairs(5, 5, True, 2) == 9
    assert counting.visible_pairs(3, 4, False, 0) == 12
    qf = torch.zeros(2, H, 5, D, dtype=torch.bfloat16)
    kf = torch.zeros(2, KH, 5, D, dtype=torch.bfloat16)
    assert counting.flash_cost(qf, kf, True, 0, 5) == (
        4 * D * H * 2 * 15, 2 * 2 * H * 5 * D * 2 + 2 * 2 * KH * 5 * D * 2)
    acc = torch.zeros(B, KH, 4, H // KH, D)
    assert counting.merge_cost(acc, torch.bfloat16) == (
        0, B * KH * 4 * (H // KH) * (D + 2) * 4 + B * H * D * 2)
    assert counting.bound_ms(3.35e9, 1.0, 3.35e12, 989e12) == (1.0, "bytes")
    assert counting.bound_ms(0.0, 989e9, 3.35e12, 989e12) == (
        1.0, "operations")


def test_wrappers_count_their_formula_and_take_meta_tensors():
    """Under a counter each wrapper counts its kernel's formula on the
    CPU (and none of its plain version's products) and on meta, where it
    returns an empty output of the kernel's shape."""
    g = torch.Generator().manual_seed(0)
    B, H, KH, S, D = 2, 4, 2, 24, 16
    q = torch.randn(B, H, D, generator=g)
    k, v = (torch.randn(B, KH, S, D, generator=g) for _ in range(2))
    lens = torch.tensor([24, 5], dtype=torch.int32)
    kp, vp = (torch.randn(KH, 16, D, generator=g) for _ in range(2))
    PS = 8
    pages = torch.randn(10, PS, KH, D, generator=g)
    table = torch.tensor([[1, 2, 3], [4, 0, 0]], dtype=torch.int32)
    qf = torch.randn(1, H, 12, D, generator=g)
    kf = torch.randn(1, KH, 12, D, generator=g)
    acc = torch.randn(B, KH, 3, H // KH, D, generator=g)
    m = torch.randn(B, KH, 3, H // KH, generator=g)
    calls = [
        ("decode_attention", tdec.decode_attention, (q, k, v, lens),
         lambda q, k, v, ln: counting.decode_cost(q, k, ln), (B, H, D)),
        ("paged_decode_attention", tpaged.paged_decode_attention,
         (q, pages, pages, table, lens),
         lambda q, kp, vp, t, ln: counting.paged_cost(q, kp, t, ln),
         (B, H, D)),
        ("prefix_attention", tprefix.prefix_attention,
         (q, kp, vp, k, v, lens),
         lambda q, kp, vp, ks, vs, ln: counting.prefix_cost(q, kp, ks, ln),
         (B, H, D)),
        ("flash_attention", tflash.flash_attention, (qf, kf, kf),
         lambda q, k, v: counting.flash_cost(q, k, True, 0, 12),
         (1, H, 12, D)),
        ("lse_merge_partials",
         lambda a, mm, l: tpaged.lse_merge_partials(a, mm, l,
                                                    torch.float32),
         (acc, m, m.exp()),
         lambda a, mm, l: counting.merge_cost(a, torch.float32), (B, H, D)),
    ]
    for name, fn, args, cost_fn, shape in calls:
        cost = cost_fn(*args)
        with counting.Counter() as c:
            want = fn(*args)
        assert c.kernels == {name: {"calls": 1, "flops": cost[0],
                                    "bytes": cost[1]}}, name
        assert (c.dot_flops, c.dot_bytes, c.dots) == (*cost, 0), name
        margs = [a.to("meta") for a in args]
        with counting.Counter() as cm:
            got = fn(*margs)
        assert got.device.type == "meta" and got.shape == want.shape \
            == shape and got.dtype == want.dtype, name
        assert (cm.dot_flops, cm.dot_bytes) == cost_fn(*margs), name
        if name in ("flash_attention", "lse_merge_partials"):
            assert cost_fn(*margs) == cost, name     # no lens to read
    # the partial calls on meta: empty outputs of the CPU version's shapes
    for fn, args in ((tprefix.prefix_partial, (q, kp, vp)),
                     (tpaged.paged_decode_partials,
                      (q, pages, pages, table, lens))):
        want = fn(*args)
        got = fn(*(a.to("meta") for a in args))
        assert [t.shape for t in got] == [t.shape for t in want]
        assert all(t.device.type == "meta" for t in got)


def test_collective_rule_by_hand():
    """smollm-360m decode_32k on one pod: vocab (49152) and ff (2560)
    split 16 ways over "model", 15 heads not: one all-reduce of the
    embedding lookup and one of each layer's SwiGLU output, [128 / 16
    lanes, 960] bf16; 5 kv heads do not split, so the cache's sequence
    takes "model" and each layer merges its f32 softmax partials
    [8, 15, 64 + 2] over it. No parameter splits over "data" (serving
    does not FSDP a model this small)."""
    cell = tdry.build_cell("smollm-360m", "decode_32k")
    with tdry.applied(cell.layout):
        rule = tdry.rule_collectives(cell)
    by = {}
    for e in rule:
        key = (e["kind"], e["source"])
        b, n = by.get(key, (0, 0))
        by[key] = (b + e["bytes"], n + e["count"])
    lanes, d, L = 8, 960, 32
    assert by == {
        ("all-reduce", "tensor-parallel all-reduce"):
            (lanes * d * 2 * (1 + L), 1 + L),
        ("all-reduce", "split-KV merge"): (lanes * 15 * 66 * 4 * L, L)}


# ---------------------------------------------------------------------------
# (f) the CLI and the report
# ---------------------------------------------------------------------------

def test_cli_record_and_roofline_report(tmp_path, capsys):
    assert tdry.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                      "--out", str(tmp_path)]) == 0
    assert capsys.readouterr().out.startswith(
        "OK  smollm-360m__decode_32k__pod1: count=")
    rec = json.loads((tmp_path / "smollm-360m__decode_32k__pod1.json")
                     .read_text())
    assert rec["devices"] == 256 and rec["mesh"] == "16x16"
    assert rec["memory"]["temp_bytes"] is None
    api = tzoo.build(ARCHS["smollm-360m"])
    assert rec["model"]["n_params"] == api.n_params
    assert rec["model"]["model_flops"] == 2.0 * api.n_active_params * 128
    cnt = rec["count"]
    assert cnt["dot_flops"] * 256 == cnt["dot_flops_global"]
    assert cnt["kernels"]["decode_attention"]["calls"] == 32
    # the per-device argument bytes: smollm's serve layout, by hand
    cell = tdry.build_cell("smollm-360m", "decode_32k")
    assert rec["memory"]["argument_bytes"] == tdry.tree_shard_bytes(
        cell.args, cell.arg_pspecs, cell.mesh)
    rows = roofline_report.run(dryrun_dir=str(tmp_path))
    out = capsys.readouterr().out
    assert out.startswith("===== roofline_pod1 =====")
    assert (tmp_path / "roofline_pod1.csv").exists()
    t = R.roofline_from_record(rec, rec["model"]["model_flops"])
    assert len(rows) == 1
    row = rows[0]
    assert (row["arch"], row["shape"]) == ("smollm-360m", "decode_32k")
    assert row["step_s"] == t.step_time_s and row["bound"] == t.dominant
    assert row["useful"] == t.useful_ratio < 1.0
    assert row["peak_GiB"] is None
