"""The split merge of one source tree of the port, timed on the card, and
its decode outputs kept for a bit-for-bit comparison with another tree's.

    python time_split_merge.py --src src --label change \
        --out chiprun_out/merge_change.pt
    python time_split_merge.py --compare chiprun_out/merge_parent.pt \
        chiprun_out/merge_change.pt

For the tree whose ``src`` it is given, on the card, it prints one JSON
line per timed call: the standalone merge (``lse_merge_partials``) at
``chip_smoke.MERGE_SLOTS`` x ``MERGE_WIDTHS`` beside its bound and a
launch floor (``chip_smoke.merge_phase``), then the paged and split-K
decode calls at the shapes the serving phases of ``chip_smoke.py`` give
them (random bf16 tensors from fixed seeds, the served lane counts and
lens), each call's mean device time (``chip_smoke.time_ms``: CUDA events,
the L2 flushed and a spin kernel queued ahead). It saves every call's
output to ``--out``. ``--compare`` reads two such files and prints, for
each call, whether the outputs are equal bit for bit and, where not, the
largest difference in units of the last place of the output dtype.
To compare a parent commit with this tree in one chip call, unpack it
into the gitignored ``build/parent`` (``git archive``) and run the two
trees in turns: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the shared shapes and timing)

# paged decode (model, H, KH, D), B, P, max len, masked lanes: the kernel
# phase's smollm-360m and mistral-7b rows, the mistral-7b and
# mixtral-8x22b paged serves and mistral-7b's TP 2 / 4 head shards
# (PERF.md §6)
PAGED = [(("smollm-360m", 15, 5, 64), 1, 128, 2048, 0),
         (("smollm-360m", 15, 5, 64), 8, 128, 2048, 0),
         (("smollm-360m", 15, 5, 64), 32, 128, 2048, 0),
         (("smollm-360m", 15, 5, 64), 8, 64, 349, 0),
         (("smollm-360m", 15, 5, 64), 8, 64, 376, 3),
         (("smollm-360m", 15, 5, 64), 1, 64, 1, 1),
         (("mistral-7b", 32, 8, 128), 8, 64, 1024, 0),
         (("mistral-7b", 32, 8, 128), 8, 64, 340, 2),
         (("mistral-7b", 32, 8, 128), 2, 64, 348, 0),
         (("mistral-7b", 32, 8, 128), 1, 64, 1, 1),
         (("mistral-7b tp2", 16, 4, 128), 8, 64, 340, 2),
         (("mistral-7b tp4", 8, 2, 128), 8, 64, 340, 2),
         (("mixtral-8x22b", 48, 8, 128), 8, 64, 340, 2)]
# split-K decode (model, H, KH, D), B, S, lens (lo, hi): the dense serves
# of mistral-7b and mixtral-8x22b, the library's B 8 rows, jamba's and the
# VLM's self-attention, the VLM's cross step, whisper-tiny's self and
# cross steps
DENSE = [(("mistral-7b", 32, 8, 128), 6, 1024, (314, 340)),
         (("mistral-7b", 32, 8, 128), 2, 1024, (344, 348)),
         (("mixtral-8x22b", 48, 8, 128), 6, 1024, (314, 340)),
         (("smollm-360m", 15, 5, 64), 8, 2048, (1, 2048)),
         (("mistral-7b", 32, 8, 128), 8, 8192, (1, 8192)),
         (("jamba-v0.1-52b", 32, 8, 128), 1, 4096, (1919, 1919)),
         (("llama-3.2-vision-11b cross", 32, 8, 128), 1, 1600, (1600, 1600)),
         (("whisper-tiny self", 6, 6, 64), 2, 448, (16, 16)),
         (("whisper-tiny cross", 6, 6, 64), 2, 1500, (1500, 1500))]


def dense_inputs(torch, width, B, S, lo, hi, seed):
    """q [B, H, D] and views [B, KH, S, D] of the model layout [B, S, KH,
    D], bf16, lens in [lo, hi] with the first lane at hi."""
    _, H, KH, D = width
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    q = chip_smoke.rand(torch, g, bf, B, H, D)
    k = chip_smoke.rand(torch, g, bf, B, S, KH, D).transpose(1, 2)
    v = chip_smoke.rand(torch, g, bf, B, S, KH, D).transpose(1, 2)
    lens = torch.randint(lo, hi + 1, (B,), generator=g, device="cuda")
    lens[0] = hi
    return q, k, v, lens.to(torch.int32)


def run(opts) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_split_merge: needs an NVIDIA GPU")
    sys.path.insert(0, opts.src)
    PA = importlib.import_module("repro_torch.kernels.paged_attention")
    DA = importlib.import_module("repro_torch.kernels.decode_attention")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    card = chip_smoke.card_line()
    for row in chip_smoke.merge_phase(torch, PA, flush):
        print(json.dumps(dict(label=opts.label, card=card, **row)),
              flush=True)
    outs = {}
    for width, B, P, max_len, masked in PAGED:
        name, inp = chip_smoke.paged_row_inputs(torch, width, B, P, max_len,
                                                masked)
        outs[name] = PA.paged_decode_attention(*inp).cpu()
        print(json.dumps(dict(
            label=opts.label, call=name, n_splits=PA.plan_for(
                inp[0], inp[1], inp[3])[0],
            ms=chip_smoke.time_ms(
                torch, lambda: PA.paged_decode_attention(*inp), flush))),
            flush=True)
    for j, (width, B, S, (lo, hi)) in enumerate(DENSE):
        inp = dense_inputs(torch, width, B, S, lo, hi, seed=50 + j)
        name = f"decode {width[0]} B{B} S{S}"
        outs[name] = DA.decode_attention(*inp).cpu()
        print(json.dumps(dict(
            label=opts.label, call=name,
            n_splits=DA.plan_for(inp[0], inp[1])[0],
            ms=chip_smoke.time_ms(
                torch, lambda: DA.decode_attention(*inp), flush))),
            flush=True)
    if opts.out:
        torch.save(outs, opts.out)


def compare(a: str, b: str) -> None:
    import torch
    x, y = torch.load(a), torch.load(b)
    for name in x:
        u, v = x[name], y[name]
        bits = torch.int16 if u.dtype == torch.bfloat16 else torch.int32
        ulps = (u.view(bits).long() - v.view(bits).long()).abs().max()
        print(json.dumps(dict(call=name, dtype=str(u.dtype)[6:],
                              equal=bool(torch.equal(u, v)),
                              elements_differing=int((u != v).sum()),
                              max_ulps=int(ulps))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default="src",
                    help="the tree's src directory (holds repro_torch)")
    ap.add_argument("--label", default="change")
    ap.add_argument("--out", help="where to save the decode outputs")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="compare two saved output files and stop")
    opts = ap.parse_args()
    if opts.compare:
        compare(*opts.compare)
    else:
        run(opts)


if __name__ == "__main__":
    main()
