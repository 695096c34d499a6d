"""A configuration file ported to the program and its weights drawn, on
the CPU: the two cells' weights as before (digests frozen), every decoder
of the program's catalogue drawn by its leaves' specs, and a hybrid
Mamba / attention / expert file (AI21-Jamba2-Mini's published keys) on
the layer plan it states."""

import hashlib
import json
import math

import pytest
import torch

from benchlib import model
from benchlib.flops import Dims
from benchlib.spec import BENCH_DIR

# sha256 of make_weights' leaves (path, dtype, shape, bytes, in sorted
# path order) at the sizes of ``_small``, drawn by the harness before
# leaves were drawn by their specs
DIGESTS = {
    ("mistral-7b", 7):
        "4b6afbb1881a4941ea7d1318358a6cea670bb4934373bb962f8b429b8f9fdc4b",
    ("mistral-7b", 2 ** 33 + 5):
        "c307ee9b4296e180592a8d17bd6b19eabdf204b427cb073f9f4fc7aab48e2ded",
    ("mixtral-8x22b-12l", 7):
        "09c5d9080cde2287f9c319653de8e142dd7e1ad0570a3bf03ce841b3007089c8",
    ("mixtral-8x22b-12l", 2 ** 33 + 5):
        "5d7657fa95103504caea6f876623e375fe813e01c6a64e08f5a6aa7f31c8aee2",
}

# AI21-Jamba2-Mini's config.json, the keys that give its shape
# (https://huggingface.co/ai21labs/AI21-Jamba2-Mini/blob/main/config.json)
JAMBA2_MINI = {
    "attn_layer_offset": 4, "attn_layer_period": 8,
    "expert_layer_offset": 1, "expert_layer_period": 2,
    "hidden_act": "silu", "hidden_size": 4096, "intermediate_size": 14336,
    "mamba_conv_bias": True, "mamba_d_conv": 4, "mamba_d_state": 16,
    "mamba_dt_rank": 256, "mamba_expand": 2, "mamba_proj_bias": False,
    "max_position_embeddings": 262144, "model_type": "jamba",
    "num_attention_heads": 32, "num_experts": 16, "num_experts_per_tok": 2,
    "num_hidden_layers": 32, "num_key_value_heads": 8,
    "num_logits_to_keep": 1, "rms_norm_eps": 1e-06, "sliding_window": None,
    "tie_word_embeddings": False, "use_mamba_kernels": True,
    "vocab_size": 65536, "torch_dtype": "bfloat16"}
INIT = {"embed_std": 1.0, "gain": 1.0}


def _digest(tree) -> str:
    h = hashlib.sha256()

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
            return
        h.update("/".join(path).encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())

    walk(tree, ())
    return h.hexdigest()


def _small(name):
    cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    return dict(cfg, hidden_size=64, intermediate_size=96,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                num_hidden_layers=2, vocab_size=320)


@pytest.mark.parametrize("name,seed", sorted(DIGESTS))
def test_the_cells_weights_are_bit_identical_to_before(name, seed):
    cfg = _small(name)
    p = model.make_weights(model.port_config(cfg, name), cfg, seed, "cpu")
    assert _digest(p) == DIGESTS[(name, seed)]


def _leaves(specs, params, path=()):
    if isinstance(specs, dict):
        for k in specs:
            yield from _leaves(specs[k], params[k], path + (k,))
    else:
        yield path, specs, params


def _decoders():
    from repro_torch.configs import ARCHS
    return sorted(n for n, c in ARCHS.items() if not c.encoder_decoder)


@pytest.mark.parametrize("name", _decoders())
def test_every_decoder_draws_each_leaf_at_its_stated_std(name):
    """Each leaf finite, in its dtype and shape; "ones" and "zeros" as
    given; "fan_in" at gain / sqrt(input width), "normal" at its spec's
    scale (the embedding at ``embed_std``), within the sampling error of
    its element count."""
    from repro_torch.bridge import param_specs
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    pcfg = reduced(get_config(name))
    init = {"embed_std": 0.5, "gain": 2.0}
    params = model.make_weights(pcfg, {"init": init}, 3, "cpu")
    n_drawn = 0
    for path, spec, t in _leaves(param_specs(pcfg), params):
        assert tuple(t.shape) == spec.shape, path
        assert t.dtype == getattr(torch, spec.dtype or pcfg.dtype), path
        x = t.float()
        assert torch.isfinite(x).all(), path
        if path[-1] in model.MAMBA_INIT:   # Mamba's own init, tested below
            continue
        if spec.init in ("ones", "zeros"):
            assert torch.equal(x, torch.full_like(x, spec.init == "ones")), \
                path
            continue
        want = (0.5 if path[-1] == "tok" else
                2.0 / math.sqrt(model.fan_in(spec))
                if spec.init == "fan_in" else spec.scale)
        n = x.numel()
        assert x.std().item() == pytest.approx(
            want, rel=max(0.02, 6 / math.sqrt(2 * n))), (path, n)
        n_drawn += 1
    assert n_drawn >= 5


def test_a_leafs_input_width_comes_from_its_shape_and_axes():
    from repro_torch.bridge import param_specs
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    pcfg = reduced(get_config("jamba-v0.1-52b"))
    d, f, ed = pcfg.d_model, pcfg.d_ff, pcfg.mamba_expand * pcfg.d_model
    st = param_specs(pcfg)["stack"]
    attn = st[f"p{pcfg.attn_offset}"]
    mamba = st["p0"]
    want = {attn["attn"]["wq"]: d, attn["attn"]["wk"]: d,
            attn["attn"]["wo"]: pcfg.n_heads * pcfg.head_dim,
            mamba["mamba"]["in_proj"]: d, mamba["mamba"]["x_proj"]: ed,
            mamba["mamba"]["dt_w"]: d // 16, mamba["mamba"]["out_proj"]: ed,
            mamba["ffn"]["wg"]: d, mamba["ffn"]["wd"]: f,
            st["p1"]["ffn"]["router"]: d, st["p1"]["ffn"]["wg"]: d,
            st["p1"]["ffn"]["wd"]: f,
            param_specs(pcfg)["embed"]["head"]: d}
    for spec, width in want.items():
        assert model.fan_in(spec) == width, spec


def _jamba(**over):
    """AI21-Jamba2-Mini's keys at a width of 64, its 16-layer cut."""
    cfg = dict(JAMBA2_MINI, hidden_size=64, intermediate_size=128,
               num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
               num_experts=4, mamba_dt_rank=4, num_hidden_layers=16,
               torch_dtype="float32", init=INIT)
    cfg.update(over)
    return cfg


def test_a_hybrid_file_ports_to_the_plan_it_states():
    from repro_torch.models.transformer import layer_plan
    cfg = _jamba()
    pcfg = model.port_config(cfg, "jamba2-mini-16l")
    assert pcfg.family == "hybrid" and pcfg.rope_theta == 0.0
    assert (pcfg.n_experts, pcfg.experts_per_token) == (4, 2)
    assert pcfg.head_dim == 16 and pcfg.norm_eps == 1e-6
    plan = layer_plan(pcfg)
    for j in range(16):
        pos = plan[j % pcfg.group_size]
        assert pos.mixer == ("attn" if j % 8 == 4 else "mamba"), j
        assert pos.ffn == ("moe" if j % 2 == 1 else "mlp"), j
    p = model.make_weights(pcfg, cfg, 2 ** 40 + 3, "cpu")
    m = p["stack"]["p0"]["mamba"]
    n = cfg["mamba_d_state"]
    # S4D-real: A = -(1..N) in every channel
    want = torch.log(torch.arange(1, n + 1, dtype=torch.float32))
    assert m["A_log"].shape[-1] == n
    assert torch.equal(m["A_log"], want.expand(m["A_log"].shape))
    # dt = softplus(dt_b) log-uniform in [1e-3, 1e-1], spread over it
    dt = torch.nn.functional.softplus(m["dt_b"].double())
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)
    assert dt.log10().mean().item() == pytest.approx(-2.0, abs=0.2)
    assert not torch.equal(m["dt_b"][0], m["dt_b"][1])
    assert torch.equal(m["D"], torch.ones_like(m["D"]))
    # the same seed, the same weights; Mamba's init draws after the normals
    q = model.make_weights(pcfg, cfg, 2 ** 40 + 3, "cpu")
    assert torch.equal(q["stack"]["p0"]["mamba"]["dt_b"], m["dt_b"])
    assert torch.equal(q["embed"]["head"], p["embed"]["head"])
    d = Dims.of(cfg)
    assert (d.n_attn_layers, d.n_mamba_layers, d.n_expert_layers) == \
        (2, 14, 8)


def test_the_published_file_at_full_width_ports():
    pcfg = model.port_config(dict(JAMBA2_MINI, num_hidden_layers=16), "j")
    assert (pcfg.d_model, pcfg.n_layers, pcfg.attn_offset, pcfg.moe_every,
            pcfg.moe_offset) == (4096, 16, 4, 2, 1)
    d = Dims.of(JAMBA2_MINI)
    assert (d.d_inner, d.d_state, d.d_conv, d.dt_rank, d.head_dim) == \
        (8192, 16, 4, 256, 128)


@pytest.mark.parametrize("over,says", [
    ({"mamba_dt_rank": 8}, "mamba_dt_rank"),
    ({"mamba_proj_bias": True}, "mamba_proj_bias"),
    ({"mamba_conv_bias": False}, "mamba_conv_bias"),
    ({"hidden_act": "gelu"}, "hidden_act"),
    ({"moe_intermediate_size": 96}, "moe_intermediate_size"),
    ({"num_local_experts": 8}, "num_local_experts"),
    ({"num_hidden_layers": 12}, "periods"),
    ({"expert_layer_period": 3}, "layer"),
])
def test_a_key_the_program_would_not_honour_raises(over, says):
    with pytest.raises(ValueError, match=says):
        model.port_config(_jamba(**over), "j")


def test_an_expert_period_the_program_cannot_tile_raises():
    cfg = _small("mixtral-8x22b-12l")
    cfg.update(expert_layer_period=2, expert_layer_offset=1)
    with pytest.raises(ValueError, match="layer 1"):
        model.port_config(cfg, "x")


def test_port_still_overrides_and_a_missing_theta_is_none():
    cfg = _small("mixtral-8x22b-12l")
    assert model.port_config(cfg, "x").rope_theta == 1e6
    cfg.pop("rope_theta")
    cfg["port"] = {"capacity_factor": 8.0}
    pcfg = model.port_config(cfg, "x")
    assert pcfg.rope_theta == 0.0 and pcfg.capacity_factor == 8.0


def _mamba_decoders():
    from repro_torch.configs import ARCHS
    return [n for n in _decoders() if ARCHS[n].attn_period]


def _is_mambas_init(m):
    """A_log S4D-real in every channel; dt = softplus(dt_b) within
    [1e-3, 1e-1] to the rounding of dt_b's dtype, drawn apart in each
    channel."""
    n = m["A_log"].shape[-1]
    want = torch.log(torch.arange(1, n + 1, dtype=torch.float32))
    assert torch.equal(m["A_log"], want.expand(m["A_log"].shape))
    b = m["dt_b"].double()
    lo, hi = (math.log(math.expm1(x)) for x in (1e-3, 1e-1))
    eps = torch.finfo(m["dt_b"].dtype).eps * b.abs()
    assert (b >= lo - eps).all() and (b <= hi + eps).all()
    assert len(set(b.reshape(-1).tolist())) > 16


@pytest.mark.parametrize("gain", [1.0, 2.0])
@pytest.mark.parametrize("name", _mamba_decoders())
def test_a_mamba_layer_takes_mambas_init_whatever_the_file_says(name, gain):
    """No key of the file sets or switches off Mamba's init: the
    program's "zeros" A_log would make A = -1 in every channel."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    pcfg = reduced(get_config(name))
    p = model.make_weights(pcfg, {"init": {"embed_std": 1.0, "gain": gain}},
                           5, "cpu")
    mambas = [v["mamba"] for v in p["stack"].values() if "mamba" in v]
    assert mambas, name
    for m in mambas:
        _is_mambas_init(m)
