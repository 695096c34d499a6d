"""A configuration file as the program runs it, and its weights.

``port_config`` maps the file's published keys (Hugging Face names) onto
the program's model configuration; ``"port"`` in the file may set further
fields of it. ``make_weights`` draws the weights on the device from the
run's seed, in the program's parameter layout, at the scale the file's
``"init"`` states; the same tensors go to the program and, after the
window, to the reference.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

# input width of each weight matrix by leaf name: the "fan in" whose
# square root divides a leaf's standard deviation
FAN_IN = {"wq": "d", "wk": "d", "wv": "d", "wo": "hd", "wg": "d", "wu": "d",
          "wd": "f", "router": "d", "head": "d"}
ALIGN = 128                 # elements between leaf starts in a buffer
DRAW = 1 << 30              # elements drawn in one call


def port_config(cfg: Dict[str, Any], name: str):
    from repro_torch.configs.base import ModelConfig
    fields = dict(
        name=name, family="moe" if cfg.get("num_local_experts") else "dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        head_dim=cfg["head_dim"],
        n_experts=cfg.get("num_local_experts") or 0,
        experts_per_token=cfg.get("num_experts_per_tok") or 0,
        sliding_window=cfg.get("sliding_window") or 0,
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=bool(cfg.get("tie_word_embeddings", False)),
        dtype=cfg["torch_dtype"])
    fields.update(cfg.get("port", {}))
    return ModelConfig(**fields)


def _std(leaf: str, cfg: Dict[str, Any], init: Dict[str, Any]) -> float:
    if leaf == "tok":
        return float(init["embed_std"])
    width = {"d": cfg["hidden_size"],
             "hd": cfg["num_attention_heads"] * cfg["head_dim"],
             "f": cfg["intermediate_size"]}[FAN_IN[leaf]]
    return init["gain"] / math.sqrt(width)


def make_weights(pcfg, cfg: Dict[str, Any], seed: int, device):
    """The program's parameter tree, each leaf in its dtype, normal leaves
    drawn into one buffer per dtype with a generator on ``device``."""
    from repro_torch.bridge import param_specs
    init = cfg["init"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    leaves = []

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        dt = getattr(torch, tree.dtype or pcfg.dtype)
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
                _std(r[0][-1], cfg, init))

    def resolve(t):
        if isinstance(t, dict):
            return {k: resolve(v) for k, v in t.items()}
        return t if isinstance(t, torch.Tensor) else t[3]

    return resolve(tree)
