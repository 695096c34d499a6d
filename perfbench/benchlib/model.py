"""A configuration file as the program runs it, and its weights.

``port_config`` maps the file's published keys (Hugging Face names) onto
the program's model configuration: dense and expert decoders (Mistral,
Mixtral) and hybrid Mamba / attention / expert stacks (Jamba's
``attn_layer_period`` / ``_offset``, ``expert_layer_period`` /
``_offset``, ``num_experts``, ``mamba_*``). A published key that the
program would not honour raises. ``"port"`` in the file may set further
fields of the program's configuration.

``make_weights`` draws the weights on the device from the run's seed, in
the program's parameter layout, each leaf by the init kind its spec
states, at the scale the file's ``"init"`` gives, and a Mamba layer's
``A_log`` and ``dt_b`` by Mamba's published init; the same tensors go to
the program and, after the window, to the reference.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

ALIGN = 128                 # elements between leaf starts in a buffer
DRAW = 1 << 30              # elements drawn in one call
# axes that stack copies of one matrix, and the model-width axes a leaf
# may map onto (``bridge.Spec``'s vocabulary)
STACKED = ("layers", "experts", "halfexpert")
TO_MODEL = ("embed", "expert_in")
DT_RANGE = (1e-3, 1e-1)     # Mamba's published dt_min, dt_max
DT_FLOOR = 1e-4             # and dt_init_floor


def _experts(cfg: Dict[str, Any]) -> int:
    a, b = cfg.get("num_local_experts"), cfg.get("num_experts")
    if a and b and a != b:
        raise ValueError(f"num_local_experts {a} and num_experts {b} differ")
    return a or b or 0


def _refuse(cfg: Dict[str, Any], pcfg) -> None:
    """Raise where a published key says what the program does not
    compute."""
    from repro_torch.models.mamba import dt_rank
    from repro_torch.models.transformer import layer_plan
    wrong = []
    if cfg.get("hidden_act", "silu") != "silu":
        wrong.append(f"hidden_act {cfg['hidden_act']!r}: the FFNs are SwiGLU")
    fe = cfg.get("moe_intermediate_size")
    if fe is not None and fe != pcfg.d_ff:
        wrong.append(f"moe_intermediate_size {fe}: experts are {pcfg.d_ff} "
                     "wide, as the dense FFN")
    if pcfg.attn_period:
        r = cfg.get("mamba_dt_rank", "auto")
        r = math.ceil(pcfg.d_model / 16) if r == "auto" else r
        if r != dt_rank(pcfg):
            wrong.append(f"mamba_dt_rank {r}: the program's is "
                         f"{dt_rank(pcfg)} (hidden_size / 16)")
        if not cfg.get("mamba_conv_bias", True):
            wrong.append("mamba_conv_bias false: the conv has a bias")
        if cfg.get("mamba_proj_bias", False):
            wrong.append("mamba_proj_bias true: the projections have none")
    n, g = pcfg.n_layers, pcfg.group_size
    if n % g:
        wrong.append(f"{n} layers are no whole number of {g}-layer periods")
    else:
        plan = layer_plan(pcfg)
        ap, ao = cfg.get("attn_layer_period", 1), cfg.get("attn_layer_offset",
                                                          0)
        ep, eo = cfg.get("expert_layer_period", 1), cfg.get(
            "expert_layer_offset", 0)
        for j in range(n):
            pos = plan[j % g]
            mixer = "attn" if j % ap == ao else "mamba"
            ffn = "moe" if pcfg.n_experts and j % ep == eo else "mlp"
            if (pos.mixer, pos.ffn) != (mixer, ffn):
                wrong.append(f"layer {j}: the file's plan is {mixer} + {ffn}"
                             f", the program's {pos.mixer} + {pos.ffn}")
                break
    if wrong:
        raise ValueError("the program would not run what the file states: "
                         + "; ".join(wrong))


def port_config(cfg: Dict[str, Any], name: str):
    """The program's ``ModelConfig`` of a configuration file. A missing
    ``rope_theta`` means no rotary positions (0); a missing ``head_dim``
    is hidden_size / num_attention_heads."""
    from repro_torch.configs.base import ModelConfig
    d, heads, experts = (cfg["hidden_size"], cfg["num_attention_heads"],
                         _experts(cfg))
    hybrid = "attn_layer_period" in cfg
    fields = dict(
        name=name,
        family="hybrid" if hybrid else ("moe" if experts else "dense"),
        n_layers=cfg["num_hidden_layers"], d_model=d, n_heads=heads,
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        head_dim=cfg.get("head_dim") or d // heads,
        n_experts=experts,
        experts_per_token=cfg.get("num_experts_per_tok") or 0,
        sliding_window=cfg.get("sliding_window") or 0,
        rope_theta=float(cfg.get("rope_theta") or 0.0),
        norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=bool(cfg.get("tie_word_embeddings", False)),
        dtype=cfg["torch_dtype"])
    if "expert_layer_period" in cfg:
        fields.update(moe_every=cfg["expert_layer_period"],
                      moe_offset=cfg.get("expert_layer_offset", 0))
    if hybrid:
        fields.update(attn_period=cfg["attn_layer_period"],
                      attn_offset=cfg.get("attn_layer_offset", 0),
                      mamba_d_state=cfg["mamba_d_state"],
                      mamba_d_conv=cfg["mamba_d_conv"],
                      mamba_expand=cfg["mamba_expand"])
    fields.update(cfg.get("port", {}))
    pcfg = ModelConfig(**fields)
    _refuse(cfg, pcfg)
    return pcfg


def fan_in(spec) -> int:
    """A weight leaf's input width, from its shape and axes. Past the axes
    that stack copies of one matrix (layers, experts), a leaf whose last
    axis is the model width takes every other axis in (wo [H, Dh, d]: H
    Dh; wd [f, d]: f; out_proj [ed, d]: ed); any other leaf takes its
    first axis in (wq [d, H, Dh]: d; x_proj [ed, R + 2N]: ed; dt_w [R,
    ed]: R)."""
    dims = [(n, a) for n, a in zip(spec.shape, spec.axes) if a not in STACKED]
    if dims[-1][1] in TO_MODEL:
        return math.prod(n for n, _ in dims[:-1])
    return dims[0][0]


def std_of(leaf: str, spec, init: Dict[str, Any]) -> float:
    """The standard deviation of a drawn leaf: the embedding at
    ``embed_std``, a "fan_in" leaf at gain / sqrt(its input width), a
    "normal" one at its spec's scale."""
    if leaf == "tok":
        return float(init["embed_std"])
    if spec.init == "fan_in":
        return init["gain"] / math.sqrt(fan_in(spec))
    return float(spec.scale)


def s4d_real(t: torch.Tensor, gen: torch.Generator) -> None:
    """A_log = log(1..N) along the state axis, in every channel (S4D-real,
    Mamba's published init, arXiv:2312.00752)."""
    n = t.shape[-1]
    t.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=t.device)).expand(t.shape))


def mamba_dt_bias(t: torch.Tensor, gen: torch.Generator) -> None:
    """dt's bias = softplus^-1(dt), dt drawn log-uniform in [1e-3, 1e-1]
    and floored at 1e-4 (Mamba's published init)."""
    lo, hi = (math.log(x) for x in DT_RANGE)
    u = torch.rand(t.shape, generator=gen, dtype=torch.float32,
                   device=t.device)
    dt = torch.exp(u * (hi - lo) + lo).clamp_(min=DT_FLOOR)
    t.copy_(dt + torch.log(-torch.expm1(-dt)))


# the Mamba leaves whose init the architecture fixes (arXiv:2312.00752),
# by leaf name; every other leaf is drawn by its spec
MAMBA_INIT = {"A_log": s4d_real, "dt_b": mamba_dt_bias}


def make_weights(pcfg, cfg: Dict[str, Any], seed: int, device):
    """The program's parameter tree, each leaf in its dtype, drawn with a
    generator on ``device``: "ones" and "zeros" leaves as given, "fan_in"
    and "normal" leaves into one normal buffer per dtype (leaves in tree
    order, dtypes in a fixed order), then each leaf of ``MAMBA_INIT`` in
    tree order."""
    from repro_torch.bridge import param_specs
    init = cfg["init"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    leaves: List[list] = []
    ruled: List[list] = []

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        dt = getattr(torch, tree.dtype or pcfg.dtype)
        if path[-1] in MAMBA_INIT:
            rec = [path, tree, dt, torch.empty(tree.shape, dtype=dt,
                                               device=device)]
            ruled.append(rec)
            return rec
        if tree.init in ("ones", "zeros"):
            fill = 1.0 if tree.init == "ones" else 0.0
            return torch.full(tree.shape, fill, dtype=dt, device=device)
        rec = [path, tree, dt, None]
        leaves.append(rec)
        return rec

    tree = walk(param_specs(pcfg), ())
    for dt in sorted({r[2] for r in leaves}, key=str):   # a fixed order
        mine = [r for r in leaves if r[2] == dt]
        ofs, starts = 0, []
        for r in mine:
            starts.append(ofs)
            ofs += -(-math.prod(r[1].shape) // ALIGN) * ALIGN
        buf = torch.empty(ofs, dtype=dt, device=device)
        for lo in range(0, ofs, DRAW):
            buf[lo:lo + DRAW].normal_(generator=gen)
        for r, s in zip(mine, starts):
            n = math.prod(r[1].shape)
            r[3] = buf[s:s + n].view(r[1].shape).mul_(
                std_of(r[0][-1], r[1], init))
    for r in ruled:
        MAMBA_INIT[r[0][-1]](r[3], gen)

    def resolve(t):
        if isinstance(t, dict):
            return {k: resolve(v) for k, v in t.items()}
        return t if isinstance(t, torch.Tensor) else t[3]

    return resolve(tree)
