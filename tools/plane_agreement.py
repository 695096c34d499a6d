"""How far the two data planes agree on full-width mistral-7b in float32,
on the card. A development tool, not part of the port, and not a check:
it prints a diagnostic.

    python tools/plane_agreement.py [--layers 4 32]

For each depth it builds mistral-7b at full width in float32 (random
weights from seed 0: about 3.6 GB at 4 layers, 29 GB at 32), serves
``chip_smoke.py``'s mistral stream (8 toolbench requests with a shared
head and distinct tails, in two waves) once on the automatic plane (paged
fused) and once with ``paged=False``, and prints one JSON line: the
shares of output tokens, and of first output tokens, on which the two
planes agree.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke  # noqa: E402  (the mistral stream and its serve loop)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 32])
    args = ap.parse_args()
    import torch
    from repro_torch import configs, full_precision_matmuls
    from repro_torch.core.request import Request
    from repro_torch.data import gen_workload
    from repro_torch.models import zoo
    from repro_torch.serving.engine import Engine, EngineConfig

    full_precision_matmuls()
    print(chip_smoke.card_line())
    base = configs.get_config("mistral-7b")
    for n_layers in args.layers:
        cfg = dataclasses.replace(base, n_layers=n_layers, dtype="float32")
        params = zoo.build(cfg).init(
            torch.Generator(device="cuda").manual_seed(0), "cuda")
        outputs = {}
        for plane, paged in (("auto", None), ("dense", False)):
            eng = Engine(cfg, params,
                         EngineConfig(**chip_smoke.MISTRAL_ECONF,
                                      paged=paged), device="cuda")
            reqs = chip_smoke.mistral_requests(Request, gen_workload,
                                               cfg.vocab_size)
            chip_smoke.serve_waves(eng, reqs)
            chip_smoke.check_outputs(f"mistral float32 {plane}", reqs,
                                     cfg.vocab_size)
            outputs[plane] = [list(r.output_tokens) for r in reqs]
            del eng
        print(json.dumps(dict(layers=n_layers, dtype="float32",
                              **chip_smoke.agreement(outputs))))
        del params
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
