"""Sharded training of the port (``train/sharded.py``, the collectives of
``launch/mesh.py``, ``shard_tree`` / ``unshard_tree``, the elastic
restore and the train CLI over a host mesh) against the JAX package, with
the mesh's shards emulated on the CPU:

(a) layout: every leaf of a training state (parameters, float32 and int8
    moments with their scales, masters, ``ef_error``, count, step) cut
    by ``state_sharding`` on ("data", "model") meshes has, on each
    shard, the shape and the values of the block that JAX's
    ``NamedSharding`` gives the device at that mesh position, the specs
    from the reference's ``param_shardings(..., train_policy(mesh))``
    and its int8-scale rule, on conftest's 8 emulated devices; reduced
    smollm-360m and mixtral-8x22b (with 6 experts on a (2, 4) mesh its
    expert ff dim goes over ("model", "data"));
(b) ``unshard_tree(shard_tree(x)) == x`` bit for bit;
(c) three ``make_sharded_train_step`` steps of a 2-layer reduced
    smollm-360m in float32 on (2, 1), (4, 1), (2, 2) and (1, 2) against
    the JAX package's one-device ``make_train_step``, in the default
    ``TrainConfig`` and each variant of tests/test_torch_train.py; a
    ``loss_mask`` that gives the data shards unequal kept-token counts;
    a batch (and a microbatch) that the data axes do not divide; the
    6-expert mixtral on (2, 2) and (2, 4);
(d) the gradient reduce a step issues equals ``dryrun.rule_collectives``'
    "gradient reduce" entries in bytes;
(e) checkpoints: a (4, 1) state saved, its files byte-identical to a
    one-device save, restored onto (2, 1) and one device and by the JAX
    package bit-exact, and a step from the restored state equal to one
    from the saved state;
(f) the train CLI with ``--shards 4`` on the CPU against the one-shard
    CLI, and its resume with ``--shards 2``.

Tolerances are tests/test_torch_train.py's: a step's loss, grad norm and
lr to 1e-5 relative; parameters within 2.1 lr of the reference's after
a step from its state (an Adam step on a gradient near 0 is +-lr either
way; with int8 compression or moments a value within rounding of a half
step rounds either way) and 2.1 of the base lr after the chain of three.
The CLI trains bfloat16 weights: its losses to the one-shard CLI's
within 2^-7 relative (one bfloat16 ulp; the shards sum their bfloat16
grads in float32 and round once more), its parameters within one
bfloat16 ulp plus 2.1 lr.
"""

import dataclasses
import functools
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import ARCHS, reduced
from repro.launch import sharding as jshard
from repro.models import zoo as jzoo
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch import bridge
from repro_torch.analysis import counting
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import ShapeSpec
from repro_torch.configs import reduced as treduced
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshard
from repro_torch.launch import train as tcli
from repro_torch.models import zoo as tzoo
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import sharded as tsh
from repro_torch.train import train_loop as tloop

torch.set_num_threads(1)

F32_RTOL = 1e-6
STEP_RTOL = 1e-5
BF16_REL = 2 ** -7
FAN_IN_GAIN = 0.3
LR = 3e-3
VARIANTS = [{}, dict(grad_accum=2), dict(compress_grads=True),
            dict(quant_moments=True),
            dict(grad_accum=2, compress_grads=True, quant_moments=True)]
MESHES = [(2, 1), (4, 1), (2, 2), (1, 2)]
# kept tokens of each of the 4 rows: the data shards' counts differ
MASK_KEEP = (32, 5, 0, 17)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _close(got, want, rtol, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g.astype(np.float64) - w).max()) / scale
    assert err <= rtol, (what, err)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return bridge.tree_to_numpy(x).tobytes()
    return np.asarray(x).tobytes()


def _same_bits(got, want):
    ft, fj = _flat(got), _flat(want)
    assert set(ft) == set(fj)
    for k in fj:
        assert _bits(ft[k]) == _bits(fj[k]), k
        assert tuple(ft[k].shape) == tuple(np.shape(fj[k])), k


def _cpu_mesh(shape):
    return tmesh.make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


def _cfgs(arch="smollm-360m", **kw):
    kw = {"n_layers": 2, "dtype": "float32", **kw}
    return (dataclasses.replace(reduced(ARCHS[arch]), **kw),
            dataclasses.replace(treduced(TARCHS[arch]), **kw))


MIXTRAL6 = dict(arch="mixtral-8x22b", n_experts=6)


def _np_params(cfg, seed):
    """The specs' init kinds, "fan_in" at 0.3 of the reference's scale
    (tests/test_torch_loss.py's module doc says why)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        dt = np.float32
        if tree.init in ("zeros", "ones"):
            return np.full(tree.shape, tree.init == "ones", dt)
        scale = (FAN_IN_GAIN / np.sqrt(tree.shape[-2])
                 if tree.init == "fan_in" else tree.scale)
        return (scale * rng.standard_normal(tree.shape)).astype(dt)

    return walk(bridge.param_specs(cfg))


def _batch(cfg, B=4, S=32, mask=False, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        m = np.zeros((B, S), np.float32)
        for r, keep in enumerate(MASK_KEEP[:B]):
            m[r, :keep] = 1.0
        out["loss_mask"] = m
    return out


def _train_cfgs(opts):
    kw = dict(total_steps=200, warmup_steps=5, **opts)
    return (jloop.TrainConfig(adamw=jopt.AdamWConfig(lr=LR), **kw),
            tloop.TrainConfig(adamw=topt.AdamWConfig(lr=LR), **kw))


def _key(opts):
    return tuple(sorted(opts.items()))


@functools.lru_cache(maxsize=None)
def _jax_step(okey, ckey):
    jcfg, _ = _cfgs(**dict(ckey))
    jtc, _ = _train_cfgs(dict(okey))
    return jax.jit(jloop.make_train_step(jzoo.build(jcfg), jtc))


@functools.lru_cache(maxsize=None)
def _jax_run(okey, ckey=(), B=4, mask=False):
    """Three JAX steps from the bridged parameters on one fixed batch:
    [(state before the step as numpy, metrics as floats)], the final
    state; shared by every mesh of a case."""
    jcfg, tcfg = _cfgs(**dict(ckey))
    jtc, _ = _train_cfgs(dict(okey))
    step = _jax_step(okey, ckey)
    state = jloop.init_state(jax.tree.map(jnp.asarray,
                                          _np_params(tcfg, 0)), jtc)
    jb = jax.tree.map(jnp.asarray, _batch(tcfg, B, mask=mask))
    runs = []
    for _ in range(3):
        before = jax.tree.map(np.asarray, state.as_dict())
        state, m = step(state, jb)
        runs.append((before, {k: float(v) for k, v in m.items()}))
    return runs, jax.tree.map(np.asarray, state.as_dict())


def _check_steps(opts, shape, ckey=(), B=4, mask=False):
    """Each of three sharded steps from the reference's state before it,
    and the port's own chain of three, against the JAX steps."""
    _, tcfg = _cfgs(**dict(ckey))
    _, ttc = _train_cfgs(opts)
    mesh = _cpu_mesh(shape)
    api = tzoo.build(tcfg)
    step = tsh.make_sharded_train_step(api, ttc, mesh)
    lay = step.sharding
    runs, jfinal = _jax_run(_key(opts), ckey, B, mask)
    tb = {k: torch.from_numpy(v) for k, v in
          _batch(tcfg, B, mask=mask).items()}
    chain = tsh.init_sharded_state(
        bridge.tree_from_numpy(_np_params(tcfg, 0), "cpu"), lay, ttc)
    for i, (before, jm) in enumerate(runs):
        synced = tsh.shard_state(tloop.TrainState.from_dict(
            bridge.tree_from_numpy(before, "cpu")), lay)
        new, tm = step(synced, tb)
        chain, cm = step(chain, tb)
        for k in ("loss", "grad_norm", "lr"):
            assert tm[k].dtype == torch.float32
            _close(tm[k], jm[k], STEP_RTOL, (opts, shape, i, k))
        _close(cm["loss"], jm["loss"], STEP_RTOL, (opts, shape, i, "chain"))
        after = runs[i + 1][0] if i < 2 else jfinal
        got = tsh.unshard_state(new, lay)
        assert int(got.step) == i + 1
        lr = jm["lr"]
        ft, fj = _flat(got.params), _flat(after["params"])
        for k in fj:
            d = np.abs(_np(ft[k]) - fj[k]).max()
            assert d <= 2.1 * lr + F32_RTOL * np.abs(fj[k]).max(), \
                (opts, shape, i, k, d / lr)
    whole = tsh.unshard_state(chain, lay)
    fc, fj = _flat(whole.params), _flat(jfinal["params"])
    for k in fj:
        assert np.abs(_np(fc[k]) - fj[k]).max() <= 2.1 * LR, (opts, k)
    assert (whole.ef_error is None) == ("ef_error" not in jfinal)
    ft, fj = _flat(whole.opt), _flat(jfinal["opt"])
    assert {k: tuple(v.shape) for k, v in ft.items()} \
        == {k: v.shape for k, v in fj.items()}


# ---------------------------------------------------------------------------
# (a) layout, (b) round trip
# ---------------------------------------------------------------------------

def _jax_state_shardings(jspecs, jm, quant):
    """The reference's layout of a training state: params, masters and
    moments by ``param_shardings(train_policy)``, an int8 moment's scale
    by its dryrun rule (the last dim's axis dropped where the spec
    reaches it), count and step replicated."""
    p_sh = jshard.param_shardings(jspecs, jm, jshard.train_policy(jm))

    def q8(ns, spec):
        ps = tuple(ns.spec)
        if len(ps) == len(spec.shape):
            ps = ps[:-1]
        return {"q": ns, "s": NamedSharding(jm, P(*ps))}
    m = (jax.tree.map(q8, p_sh, jspecs,
                      is_leaf=lambda x: isinstance(x, NamedSharding))
         if quant else p_sh)
    rep = NamedSharding(jm, P())
    return {"params": p_sh, "opt": {"m": m, "v": m, "master": p_sh,
                                    "count": rep},
            "ef_error": p_sh, "step": rep}


LAYOUTS = ([("smollm-360m", s, ()) for s in MESHES]
           + [("mixtral-8x22b", s, ()) for s in MESHES]
           + [("mixtral-8x22b", (1, 8), ()),
              ("mixtral-8x22b", (2, 4), (("n_experts", 6),))])


@pytest.mark.parametrize("arch,shape,extra", LAYOUTS,
                         ids=lambda x: "x".join(map(str, x))
                         if isinstance(x, tuple) and x and
                         isinstance(x[0], int) else str(x))
def test_state_layout_matches_named_sharding(arch, shape, extra):
    """Every state leaf of every shard: the shape of JAX's shard_shape and
    the values of the device's block (``devices_indices_map``)."""
    jcfg = dataclasses.replace(reduced(ARCHS[arch]), **dict(extra))
    tcfg = dataclasses.replace(treduced(TARCHS[arch]), **dict(extra))
    tc = tloop.TrainConfig(quant_moments=True, compress_grads=True)
    jm = jax.make_mesh(shape, ("data", "model"))
    mesh = _cpu_mesh(shape)
    lay = tsh.state_sharding(bridge.param_specs(tcfg), mesh, tc)
    jsh = _flat(_jax_state_shardings(jzoo.build(jcfg).specs, jm, True))
    state = tloop.init_state(bridge.tree_from_numpy(_np_params(tcfg, 2),
                                                    "cpu"), tc)
    whole = _flat(state.as_dict())
    # values that differ everywhere, in each leaf's dtype
    gen = torch.Generator().manual_seed(4)
    whole = {k: (torch.randint(-127, 128, v.shape, generator=gen,
                               dtype=torch.int8) if v.dtype == torch.int8
                 else (torch.randn(v.shape, generator=gen) * 100).to(v.dtype))
             for k, v in whole.items()}
    shards = [_flat(t) for t in
              tshard.shard_tree(_unflat(whole), lay.pspecs, mesh)]
    assert set(jsh) == set(whole)
    pos = {d: i for i, d in enumerate(np.asarray(jm.devices).flat)}
    split = set()
    for path, ns in jsh.items():
        full = whole[path]
        shard_shape = ns.shard_shape(tuple(full.shape))
        assert tuple(lay.pspec(path)) == tuple(ns.spec), path
        for dev, idx in ns.devices_indices_map(tuple(full.shape)).items():
            got = shards[pos[dev]][path]
            assert tuple(got.shape) == shard_shape, (path, dev)
            assert torch.equal(got, full[idx]), (path, dev)
        if shard_shape != tuple(full.shape):
            split.add(path)
    assert split
    if extra:        # the 6-expert MoE's ff dim over ("model", "data")
        assert lay.pspec(("params", "stack", "p0", "ffn", "wg"))[-1] \
            == ("model", "data")


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


@pytest.mark.parametrize("shape", MESHES + [(2, 4), (8, 1)])
def test_shard_round_trip_is_bit_exact(shape):
    """A bfloat16 state with int8 moments and error feedback, cut and put
    back; every block a fresh tensor."""
    _, tcfg = _cfgs(dtype="bfloat16")
    tc = tloop.TrainConfig(quant_moments=True, compress_grads=True)
    api = tzoo.build(tcfg)
    state = tloop.init_state(api.init(torch.Generator().manual_seed(0),
                                      "cpu"), tc)
    lay = tsh.state_sharding(api.specs, _cpu_mesh(shape), tc)
    shards = tsh.shard_state(state, lay)
    for s in shards:
        for k, v in _flat(s.as_dict()).items():
            assert v.data_ptr() != _flat(state.as_dict())[k].data_ptr()
    _same_bits(tsh.unshard_state(shards, lay).as_dict(), state.as_dict())
    assert sum(tshard.tree_bytes(s.as_dict()) for s in shards) \
        >= tshard.tree_bytes(state.as_dict())


# ---------------------------------------------------------------------------
# (c) steps against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("opts", VARIANTS,
                         ids=lambda o: "-".join(o) or "default")
def test_sharded_steps_match_jax(opts, shape):
    _check_steps(opts, shape)


@pytest.mark.parametrize("opts,shape", [({}, (4, 1)), ({}, (2, 2)),
                                        (dict(grad_accum=2), (2, 1)),
                                        (dict(grad_accum=2), (2, 2))],
                         ids=["default-4x1", "default-2x2", "accum-2x1",
                              "accum-2x2"])
def test_uneven_loss_mask(opts, shape):
    """Rows keep 32, 5, 0 and 17 tokens: each shard's loss is weighted by
    its share of the microbatch's kept tokens."""
    _check_steps(opts, shape, mask=True)


@pytest.mark.parametrize("opts,B,shape", [({}, 3, (2, 1)), ({}, 3, (4, 1)),
                                          (dict(grad_accum=2), 6, (4, 1)),
                                          (dict(grad_accum=2), 6, (2, 2))],
                         ids=["b3-2x1", "b3-4x1", "accum-b6-4x1",
                              "accum-b6-2x2"])
def test_undivided_batch_is_replicated(opts, B, shape):
    """A batch (B 3) or microbatch (3 rows of B 6 in two) that the data
    axes do not divide: every data row computes all of it, the grads are
    not summed over the rows."""
    mesh = _cpu_mesh(shape)
    assert tshard.dp_spec(mesh, B // opts.get("grad_accum", 1)) is None
    _check_steps(opts, shape, B=B)


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_sharded_steps_match_jax(shape):
    """The 6-expert reduced mixtral: experts over "model" on (2, 2); on
    (2, 4) the experts replicate and each expert's ff dim goes over
    ("model", "data"), reduce-scattered over "data"."""
    _check_steps({}, shape, ckey=tuple(sorted(MIXTRAL6.items())))


# ---------------------------------------------------------------------------
# (d) the gradient reduce against the dry-run's rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_gradient_reduce_bytes_match_the_rule(shape):
    """Per device, the step's reduce-scatters and its all-reduces of
    whole grads equal the rule's "gradient reduce" bytes for the same
    config, batch and mesh; its weight gathers are one whole-tree gather
    a data row."""
    _, tcfg = _cfgs()
    mesh = _cpu_mesh(shape)
    api = tzoo.build(tcfg)
    tc = tloop.TrainConfig()
    step = tsh.make_sharded_train_step(api, tc, mesh)
    shards = tsh.init_sharded_state(
        bridge.tree_from_numpy(_np_params(tcfg, 0), "cpu"), step.sharding,
        tc)
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    with counting.Counter() as c:
        step(shards, tb)
    cell = tdry.build_cell(tcfg, ShapeSpec("train", 32, 4, "train"),
                           mesh=mesh, overrides=dict(grad_accum=1,
                                                     quant_moments=False))
    with tdry.applied(cell.layout):
        rule = tdry.rule_collectives(cell)
    grad = {}
    for r in rule:
        if r["source"] == "gradient reduce":
            grad[r["kind"]] = grad.get(r["kind"], 0) + r["bytes"]
    n = mesh.size
    assert c.collective_bytes.get("reduce-scatter", 0) / n \
        == grad.get("reduce-scatter", 0)
    # the all-reduces also carry the two small vectors of the norm and,
    # with compression, of the absmax: one float32 a leaf each
    n_leaves = len(tsh._paths(step.sharding.pspecs["params"]))
    assert c.collective_bytes.get("all-reduce", 0) / n \
        == grad.get("all-reduce", 0) + 4 * n_leaves
    whole = sum(int(np.prod(s.shape)) * 4
                for s in _flat(bridge.param_specs(tcfg)).values())
    assert 0 < c.collective_bytes["all-gather"] <= shape[0] * whole


# ---------------------------------------------------------------------------
# (e) checkpoints
# ---------------------------------------------------------------------------

def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def test_elastic_restore(tmp_path):
    """A bfloat16 (4, 1) state after one step with int8 moments and error
    feedback: its sharded save is byte-identical to a one-device save of
    the same state; it restores onto (2, 1), onto one device and in the
    JAX package bit-exact; a (2, 1) step from the restored state equals
    the (2, 1) step from the saved state bit for bit, and the (4, 1) step
    within tolerance."""
    _, tcfg = _cfgs(dtype="bfloat16")
    tc = tloop.TrainConfig(adamw=topt.AdamWConfig(lr=LR), warmup_steps=1,
                           total_steps=20, compress_grads=True,
                           quant_moments=True)
    api = tzoo.build(tcfg)
    m4, m2 = _cpu_mesh((4, 1)), _cpu_mesh((2, 1))
    s4 = tsh.make_sharded_train_step(api, tc, m4)
    s2 = tsh.make_sharded_train_step(api, tc, m2)
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    shards = tsh.init_sharded_state(
        api.init(torch.Generator().manual_seed(0), "cpu"), s4.sharding, tc)
    shards, _ = s4(shards, tb)
    whole = tsh.unshard_state(shards, s4.sharding)
    d4, d1 = str(tmp_path / "four"), str(tmp_path / "one")
    tckpt.save_checkpoint(d4, [s.as_dict() for s in shards], 1,
                          shardings=s4.sharding)
    tckpt.save_checkpoint(d1, whole.as_dict(), 1)
    assert _files(os.path.join(d4, "step_1")) \
        == _files(os.path.join(d1, "step_1"))
    back2 = tckpt.restore_checkpoint(d4, shardings=s2.sharding)
    assert len(back2) == 2
    want2 = tsh.shard_state(whole, s2.sharding)
    for got, want in zip(back2, want2):
        _same_bits(got, want.as_dict())
    _same_bits(tckpt.restore_checkpoint(d4, device="cpu"), whole.as_dict())
    _same_bits(jckpt.restore_checkpoint(d4), whole.as_dict())
    a, ma = s2([tloop.TrainState.from_dict(d) for d in back2], tb)
    b, mb = s2(want2, tb)
    assert torch.equal(ma["loss"], mb["loss"])
    _same_bits(tsh.unshard_state(a, s2.sharding).as_dict(),
               tsh.unshard_state(b, s2.sharding).as_dict())
    c, mc = s4(shards, tb)
    for k in ("loss", "grad_norm"):
        _close(ma[k], mc[k], BF16_REL, k)


def test_restore_defaults_to_the_card(tmp_path, monkeypatch):
    tckpt.save_checkpoint(str(tmp_path), {"x": torch.ones(3)}, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tckpt.restore_checkpoint(str(tmp_path))


# ---------------------------------------------------------------------------
# (f) the CLI
# ---------------------------------------------------------------------------

CLI = ["--arch", "smollm-360m", "--reduced", "--device", "cpu", "--batch",
       "4", "--seq", "32", "--log-every", "1", "--lr", "3e-3"]
LOSS = re.compile(r"step +(\d+) loss=([0-9.]+)")


def _losses(text):
    return {int(a): float(b) for a, b in LOSS.findall(text)}


def test_cli_over_four_shards_and_resume_on_two(tmp_path, capsys):
    one = tcli.main(CLI + ["--steps", "3"])
    ref = _losses(capsys.readouterr().out)
    d = str(tmp_path / "ckpt")
    four = tcli.main(CLI + ["--steps", "3", "--shards", "4",
                            "--ckpt-dir", d])
    got = _losses(capsys.readouterr().out)
    assert sorted(got) == sorted(ref) == [1, 2, 3]
    for k in ref:
        assert abs(got[k] - ref[k]) <= BF16_REL * ref[k] + 5e-5, (k, got, ref)
    for k, x in _flat(one.params).items():
        y = _flat(four.params)[k]
        bound = BF16_REL * x.float().abs() + 2.1 * LR
        assert bool(((x.float() - y.float()).abs() <= bound).all()), k
    _same_bits(tckpt.restore_checkpoint(d, device="cpu"), four.as_dict())
    with open(os.path.join(d, "step_3", "manifest.json")) as f:
        assert json.load(f)["step"] == 3
    resumed = tcli.main(CLI + ["--steps", "5", "--shards", "2",
                               "--ckpt-dir", d])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out
    assert sorted(_losses(out)) == [4, 5]
    assert int(resumed.step) == 5 and tckpt.latest_step(d) == 5


def test_cli_with_shards_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--reduced", "--steps", "1", "--shards", "4"])
