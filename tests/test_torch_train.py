"""The port's training substrate against the JAX package's, on the same
seeded numpy inputs:

(a) the optimizer pieces: ``adamw_init`` / ``adamw_update`` (float32 and
    int8 moments, a bfloat16 parameter among float32 ones),
    ``global_norm``, ``clip_by_global_norm``, ``ef8_compress`` chained
    over steps, ``warmup_cosine``;
(b) three ``make_train_step`` steps of a 2-layer reduced smollm-360m in
    float32, in the default config and each variant of
    tests/test_train_substrate.py (grad_accum 2, int8 error feedback,
    int8 moments, all three): the port's own chain of steps, and each
    step of the port from the reference's state before it;
(c) checkpoints: the JAX package's restored by the port and the port's
    by the JAX package, bit-exact (bfloat16 parameters, int8 moments and
    their scales, ``ef_error``, the step), files byte-identical; pruning
    to the newest ``keep``; a step from a restored state equals one from
    the state that was saved;
(d) ``synthetic_batches`` equal to the reference's;
(e) ``train_policy`` / ``dp_spec`` / ``data_axes`` equal to the
    reference's for the 12 configs on ("data", "model") meshes;
(f) the train CLI on the CPU: its steps equal ``make_train_step`` on the
    same batches, a second call resumes from the checkpoint, and without
    ``--device`` it refuses to run where there is no card.

Tolerances: float32 results to 1e-6 relative (one update); a train
step's loss, grad norm and lr to 1e-5 relative (the chain's loss too);
int8 moments equal, or one apart in at most 1% of the entries (a float32
value within rounding of a half step rounds either way); parameters
within 2.1 lr of the reference's after a step and 2.1 of the base lr
after the chain (an Adam step on a gradient near 0 is +-lr either
way). Model parameters are drawn as in tests/test_torch_loss.py (the
specs' init kinds, "fan_in" at 0.3 of the reference's scale: see its
module doc).
"""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.launch import mesh as jmesh
from repro.launch import sharding as jshard
from repro.launch.train import synthetic_batches as jbatches
from repro.models import zoo as jzoo
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch import bridge
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import reduced as treduced
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshard
from repro_torch.launch import train as tcli
from repro_torch.models import zoo as tzoo
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop

torch.set_num_threads(1)

F32_RTOL = 1e-6
STEP_RTOL = 1e-5
Q_OFF_SHARE = 0.01
FAN_IN_GAIN = 0.3
LR = 3e-3
VARIANTS = [{}, dict(grad_accum=2), dict(compress_grads=True),
            dict(quant_moments=True),
            dict(grad_accum=2, compress_grads=True, quant_moments=True)]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _np(x):
    """A tensor or JAX array as numpy (bfloat16 as float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _close(got, want, rtol=F32_RTOL, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g.astype(np.float64) - w).max()) / scale
    assert err <= rtol, (what, err)


def _q_close(got, want, what=""):
    """int8 moments: equal, or one apart in at most Q_OFF_SHARE."""
    g, w = _np(got).astype(np.int32), _np(want).astype(np.int32)
    d = np.abs(g - w)
    assert d.max() <= 1 and d.mean() <= Q_OFF_SHARE, (what, d.max(),
                                                      d.mean())


def _tree_close(got, want, what=""):
    ft, fj = _flat(got), _flat(want)
    assert set(ft) == set(fj), what
    for k in fj:
        if k[-1] == "q":
            _q_close(ft[k], fj[k], (what, k))
        else:
            _close(ft[k], fj[k], what=(what, k))


def _opt_inputs(seed):
    """A parameter tree (a bfloat16 leaf among float32 ones) and grads."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 8, 16), "b": {"c": (24,), "d": (5, 12)}}

    def draw(s, scale):
        return (scale * rng.standard_normal(s)).astype(np.float32)
    p = {"a": draw(shapes["a"], 1.0),
         "b": {"c": draw(shapes["b"]["c"], 1.0),
               "d": draw(shapes["b"]["d"], 1.0)}}
    g = [{"a": draw(shapes["a"], 0.1),
          "b": {"c": draw(shapes["b"]["c"], 0.1),
                "d": draw(shapes["b"]["d"], 1e-4)}} for _ in range(3)]
    return p, g


def _jtree(t, bf16=()):
    return {k: (_jtree(v, bf16) if isinstance(v, dict) else
                jnp.asarray(v, jnp.bfloat16 if k in bf16 else jnp.float32))
            for k, v in t.items()}


def _ttree(t, bf16=()):
    return {k: (_ttree(v, bf16) if isinstance(v, dict) else
                torch.from_numpy(v).to(torch.bfloat16 if k in bf16
                                       else torch.float32))
            for k, v in t.items()}


# ---------------------------------------------------------------------------
# (a) optimizer, clip, ef8, schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True])
def test_adamw_matches_jax(quant):
    """Three chained updates from adamw_init: new params (the bfloat16
    leaf "d" cast from its master), masters, moments and count."""
    p, gs = _opt_inputs(0)
    cfg = topt.AdamWConfig(lr=1e-2)
    jcfg = jopt.AdamWConfig(lr=1e-2)
    jp, tp = _jtree(p, ("d",)), _ttree(p, ("d",))
    js = jopt.adamw_init(jp, quant_moments=quant)
    ts = topt.adamw_init(tp, quant_moments=quant)
    _tree_close(ts, js, "init")
    assert ts["count"].dtype == torch.int32
    for i, g in enumerate(gs):
        lr = 1e-2 * (i + 1) / 3
        jp, js = jopt.adamw_update(_jtree(g, ("d",)), js, jp, jcfg,
                                   jnp.float32(lr), quant=quant)
        tp, ts = topt.adamw_update(_ttree(g, ("d",)), ts, tp, cfg,
                                   torch.tensor(lr, dtype=torch.float32),
                                   quant=quant)
        assert int(ts["count"]) == int(js["count"]) == i + 1
        _tree_close(tp, jp, ("params", i))
        _tree_close({k: ts[k] for k in ("m", "v", "master")},
                    {k: js[k] for k in ("m", "v", "master")}, ("state", i))
    assert tp["b"]["d"].dtype == torch.bfloat16
    if quant:
        assert ts["m"]["a"]["q"].dtype == torch.int8
        assert ts["v"]["a"]["s"].shape == (3, 8, 1)


def test_clip_and_global_norm_match_jax():
    _, gs = _opt_inputs(1)
    for max_norm in (0.05, 1.0, 100.0):
        jc, jn = jopt.clip_by_global_norm(_jtree(gs[0], ("d",)), max_norm)
        tc, tn = topt.clip_by_global_norm(_ttree(gs[0], ("d",)), max_norm)
        _close(tn, jn, what=max_norm)
        _tree_close(tc, jc, max_norm)
        assert tc["b"]["d"].dtype == torch.bfloat16
    _close(topt.global_norm(_ttree(gs[1])), jopt.global_norm(_jtree(gs[1])))


def test_ef8_compress_matches_jax():
    """Five chained compressions of the same grads: dequantized grads and
    the carried error."""
    _, gs = _opt_inputs(2)
    je = jopt.ef8_init(_jtree(gs[0]))
    te = topt.ef8_init(_ttree(gs[0]))
    for i in range(5):
        jg, je = jopt.ef8_compress(_jtree(gs[i % 3]), je)
        tg, te = topt.ef8_compress(_ttree(gs[i % 3]), te)
        _tree_close(tg, jg, ("grads", i))
        _tree_close(te, je, ("error", i))


def test_warmup_cosine_matches_jax():
    for base, warm, total in ((3e-4, 100, 10_000), (1.0, 10, 100),
                              (3e-3, 1, 3)):
        js = jopt.warmup_cosine(base, warm, total)
        ts = topt.warmup_cosine(base, warm, total)
        for step in sorted({0, 1, warm - 1, warm, warm + 1, total // 2,
                            total - 1, total, total + 5}):
            got = ts(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            _close(got, js(jnp.int32(step)), what=(base, step))


# ---------------------------------------------------------------------------
# (b) the train step
# ---------------------------------------------------------------------------

def _small_cfgs():
    kw = dict(n_layers=2, dtype="float32")
    return (dataclasses.replace(reduced(ARCHS["smollm-360m"]), **kw),
            dataclasses.replace(treduced(TARCHS["smollm-360m"]), **kw))


def _np_params(cfg, seed):
    rng = np.random.default_rng(seed)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if tree.init in ("zeros", "ones"):
            return np.full(tree.shape, tree.init == "ones", np.float32)
        scale = (FAN_IN_GAIN / np.sqrt(tree.shape[-2])
                 if tree.init == "fan_in" else tree.scale)
        return (scale * rng.standard_normal(tree.shape)).astype(np.float32)

    return walk(bridge.param_specs(cfg))


def _fixed_batch(cfg, seed=1, B=4, S=32):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _train_cfgs(opts):
    kw = dict(total_steps=200, warmup_steps=5, **opts)
    return (jloop.TrainConfig(adamw=jopt.AdamWConfig(lr=LR), **kw),
            tloop.TrainConfig(adamw=topt.AdamWConfig(lr=LR), **kw))


def _to_port(jstate):
    """A JAX TrainState as the port's, bit for bit, on the CPU."""
    return tloop.TrainState.from_dict(bridge.tree_from_numpy(
        jax.tree.map(np.asarray, jstate.as_dict()), "cpu"))


@pytest.mark.parametrize("opts", VARIANTS,
                         ids=lambda o: "-".join(o) or "default")
def test_train_steps_match_jax(opts):
    """Three steps on one fixed batch. Each step of the port also starts
    from the reference's state before it (bridged bit for bit), and its
    loss, grad norm and lr agree to STEP_RTOL and its parameters to 2.1
    lr: with int8 compression or moments a float32 value within rounding
    of a half step rounds either way in the two packages (a whole int8
    step of that entry), so states run apart slowly; a step from the same
    state shows what one step does. The port's own chained run agrees in
    loss to STEP_RTOL and in parameters to 2.1 LR after the three
    steps."""
    jcfg, tcfg = _small_cfgs()
    jtc, ttc = _train_cfgs(opts)
    p = _np_params(tcfg, 0)
    jstate = jloop.init_state(jax.tree.map(jnp.asarray, p), jtc)
    chain = tloop.init_state(bridge.tree_from_numpy(p, "cpu"), ttc)
    jstep = jax.jit(jloop.make_train_step(jzoo.build(jcfg), jtc))
    tstep = tloop.make_train_step(tzoo.build(tcfg), ttc)
    batch = _fixed_batch(tcfg)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(3):
        synced, tm = tstep(_to_port(jstate), tb)
        chain, cm = tstep(chain, tb)
        jstate, jm = jstep(jstate, jb)
        for k in ("loss", "grad_norm", "lr"):
            assert tm[k].dtype == torch.float32
            _close(tm[k], jm[k], STEP_RTOL, (opts, i, k))
        _close(cm["loss"], jm["loss"], STEP_RTOL, (opts, i, "chained"))
        assert int(synced.step) == int(chain.step) == int(jstate.step) \
            == i + 1
        lr = float(jm["lr"])
        ft, fj = _flat(synced.params), _flat(jstate.params)
        for k in fj:
            d = np.abs(_np(ft[k]) - _np(fj[k])).max()
            assert d <= 2.1 * lr + F32_RTOL * np.abs(_np(fj[k])).max(), \
                (opts, i, k, d / max(lr, 1e-30))
    fc, fj = _flat(chain.params), _flat(jstate.params)
    for k in fj:
        d = np.abs(_np(fc[k]) - _np(fj[k])).max()
        assert d <= 2.1 * LR, (opts, k, d / LR)
    assert (chain.ef_error is None) == (jstate.ef_error is None)
    for kind in ("m", "v"):
        ft, fj = _flat(chain.opt[kind]), _flat(jstate.opt[kind])
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in ft.items()} \
            == {k: (tuple(v.shape), str(v.dtype)) for k, v in fj.items()}


# ---------------------------------------------------------------------------
# (c) checkpoints across the two packages
# ---------------------------------------------------------------------------

def _bits(x):
    """Raw bytes of a tensor or JAX array (bfloat16 as its uint16 bits)."""
    if isinstance(x, torch.Tensor):
        return bridge.tree_to_numpy(x).tobytes()
    return np.asarray(x).tobytes()


def _same_bits(got, want):
    ft, fj = _flat(got), _flat(want)
    assert set(ft) == set(fj)
    for k in fj:
        assert _bits(ft[k]) == _bits(fj[k]), k
        assert tuple(ft[k].shape) == tuple(np.shape(fj[k])), k


def _bf16_jax_state():
    """A JAX TrainState of a bfloat16 2-layer smollm after one step with
    int8 moments and error feedback (every kind of leaf a checkpoint
    holds: bfloat16 params, float32 masters and errors, int8 moments and
    their scales, int32 count and step)."""
    jcfg = dataclasses.replace(reduced(ARCHS["smollm-360m"]), n_layers=2)
    api = jzoo.build(jcfg)
    tc = jloop.TrainConfig(total_steps=20, warmup_steps=1,
                           compress_grads=True, quant_moments=True)
    state = jloop.init_state(api.init(jax.random.PRNGKey(0)), tc)
    state, _ = jax.jit(jloop.make_train_step(api, tc))(
        state, jax.tree.map(jnp.asarray, _fixed_batch(jcfg)))
    return state


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def test_checkpoints_cross_both_ways(tmp_path):
    js = _bf16_jax_state()
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_checkpoint(jd, js.as_dict(), 1)
    restored = tckpt.restore_checkpoint(jd, device="cpu")
    _same_bits(restored, js.as_dict())
    assert _flat(restored)[("params", "embed", "tok")].dtype \
        == torch.bfloat16
    assert _flat(restored)[("opt", "m", "embed", "tok", "q")].dtype \
        == torch.int8
    assert "ef_error" in restored and restored["step"].dtype == torch.int32
    tckpt.save_checkpoint(td, restored, 1)
    assert _files(os.path.join(td, "step_1")) \
        == _files(os.path.join(jd, "step_1"))
    back = jckpt.restore_checkpoint(td)
    _same_bits(restored, back)
    assert back["params"]["embed"]["tok"].dtype == jnp.bfloat16
    with open(os.path.join(td, "step_1", "manifest.json")) as f:
        man = json.load(f)
    assert man["step"] == 1
    assert {m["dtype"] for m in man["leaves"]} \
        == {"bfloat16", "float32", "int8", "int32"}


def test_checkpoint_keeps_latest_k(tmp_path):
    d = str(tmp_path)
    for s in range(6):
        tckpt.save_checkpoint(d, {"x": torch.ones(3) * s}, s, keep=3)
    assert tckpt.all_steps(d) == [3, 4, 5] == jckpt.all_steps(d)
    assert tckpt.latest_step(d) == 5
    assert torch.equal(tckpt.restore_checkpoint(d, device="cpu")["x"],
                       torch.full((3,), 5.))
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "none"), device="cpu")


def test_step_from_restored_state_is_bit_exact(tmp_path):
    """tests/test_train_substrate.py's restart case in the port: save after
    three steps with error feedback, restore, and the next step from
    either state gives the same loss and parameters."""
    _, tcfg = _small_cfgs()
    tc = tloop.TrainConfig(total_steps=20, warmup_steps=2,
                           compress_grads=True)
    state = tloop.init_state(bridge.tree_from_numpy(
        _np_params(tcfg, 0), "cpu"), tc)
    step = tloop.make_train_step(tzoo.build(tcfg), tc)
    batch = {k: torch.from_numpy(v) for k, v in _fixed_batch(tcfg).items()}
    for _ in range(3):
        state, _ = step(state, batch)
    tckpt.save_checkpoint(str(tmp_path), state.as_dict(), int(state.step))
    restored = tloop.TrainState.from_dict(
        tckpt.restore_checkpoint(str(tmp_path), device="cpu"))
    _same_bits(restored.as_dict(), state.as_dict())
    s1, m1 = step(state, batch)
    s2, m2 = step(restored, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    _same_bits(s2.params, s1.params)


# ---------------------------------------------------------------------------
# (d) data, (e) specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,batch,seq,seed", [(128, 4, 16, 0),
                                                  (49152, 8, 64, 3)])
def test_synthetic_batches_match_jax(vocab, batch, seq, seed):
    jb = jbatches(vocab, batch, seq, seed)
    tb = tcli.synthetic_batches(vocab, batch, seq, seed, device="cpu")
    for _ in range(3):
        j, t = next(jb), next(tb)
        for k in ("tokens", "labels"):
            assert t[k].dtype == torch.int32
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


def test_synthetic_batches_default_to_the_card():
    """Like every entry point of the port, the stream is made on the card
    unless the caller asks for the CPU, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.synthetic_batches(128, 2, 8)


def _jax_stand_in(shape):
    """An object with a JAX mesh's ``shape`` and ``axis_names`` (the
    policy functions read nothing else), for meshes larger than
    conftest's 8 devices."""
    names = ("data", "model")
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


MESHES = [(2, 4), (4, 2), (1, 8), (16, 16)]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_specs_match_jax(arch):
    """train_policy's PartitionSpec of every parameter leaf at full width,
    and dp_spec / data_axes, on ("data", "model") meshes: conftest's
    emulated devices for 8, a stand-in for the (16, 16) pod."""
    jspecs = jzoo.build(ARCHS[arch]).specs
    tspecs = bridge.param_specs(TARCHS[arch])
    for shape in MESHES:
        jm = (_jax_stand_in(shape) if shape[0] * shape[1] > 8
              else jax.make_mesh(shape, ("data", "model")))
        tm = tmesh.make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
        jp = _flat(jshard.param_pspecs(jspecs, jm, jshard.train_policy(jm)))
        tp = _flat(tshard.param_pspecs(tspecs, tm, tshard.train_policy(tm)))
        assert set(tp) == set(jp)
        for path, spec in jp.items():
            assert tp[path] == tuple(spec), (shape, path, tp[path], spec)
        assert tmesh.data_axes(tm) == jmesh.data_axes(jm) == ("data",)
        for b in (1, 2, 3, 8, 16, 48):
            assert tshard.dp_spec(tm, b) == jshard.dp_spec(jm, b), (shape, b)


# ---------------------------------------------------------------------------
# (f) the CLI
# ---------------------------------------------------------------------------

CLI = ["--arch", "smollm-360m", "--reduced", "--device", "cpu", "--batch",
       "4", "--seq", "32", "--log-every", "1"]


def test_cli_trains_like_make_train_step_and_resumes(tmp_path, capsys):
    """Three CLI steps equal three make_train_step steps on the CLI's
    batches, bit for bit; a second call to step 5 resumes from the step 3
    checkpoint and leaves the newest checkpoint at step 5."""
    d = str(tmp_path / "ckpt")
    state = tcli.main(CLI + ["--steps", "3", "--ckpt-dir", d])
    out = capsys.readouterr().out
    assert "step     1 loss=" in out and "done" in out
    assert "resumed" not in out
    cfg = treduced(TARCHS["smollm-360m"])
    tc = tloop.TrainConfig(adamw=topt.AdamWConfig(lr=3e-4),
                           warmup_steps=1, total_steps=3)
    api = tzoo.build(cfg)
    ref = tloop.init_state(api.init(torch.Generator().manual_seed(0),
                                    "cpu"), tc)
    step = tloop.make_train_step(api, tc)
    data = tcli.synthetic_batches(cfg.vocab_size, 4, 32, 0, device="cpu")
    for _ in range(3):
        ref, _ = step(ref, next(data))
    _same_bits(state.as_dict(), ref.as_dict())
    assert tckpt.all_steps(d) == [3]
    _same_bits(tckpt.restore_checkpoint(d, device="cpu"), state.as_dict())

    resumed = tcli.main(CLI + ["--steps", "5", "--ckpt-dir", d])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out
    assert "step     4 loss=" in out and "step     5 loss=" in out
    assert "step     1 loss=" not in out
    assert int(resumed.step) == 5 and tckpt.latest_step(d) == 5


def test_cli_defaults_to_the_card(monkeypatch):
    assert tcli.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--reduced", "--steps", "1"])
