"""A tiny benchmark in a temporary folder: its own BENCHMARK.json, a
configuration, a traffic mix, the real readers and reference copied in,
and one reader more, each found by name as a real cell's are."""

import json
import shutil
import time
from pathlib import Path

from benchlib import cell as C
from benchlib.spec import BENCH_DIR, ROOT, load_cell

NEW_METRIC = '''"""tokens_per_step: tokens emitted per model step of the window."""


def read(run):
    steps = [s for s in run.steps if s.kind != "idle"]
    if not steps:
        return None
    return sum(s.produced for s in steps) / len(steps)
'''


def make(tmp: Path, dtype="float32", moe=False, layers=2, d=64,
         limits=None, chips=1) -> Path:
    """``limits``: the compared numbers' limits (default the tiny
    model's own, tighter than any cell's); ``chips``: the cell's."""
    bench = tmp / "bench"
    for sub in ("metrics", "reference"):
        shutil.copytree(BENCH_DIR / sub, bench / sub)
    (bench / "metrics" / "tokens_per_step.py").write_text(NEW_METRIC)
    (bench / "configs").mkdir()
    (bench / "traffic").mkdir()
    cfg = json.loads((BENCH_DIR / "configs" / "mistral-7b.json").read_text())
    cfg.update(hidden_size=d, intermediate_size=2 * d, num_attention_heads=4,
               num_key_value_heads=2, head_dim=d // 4,
               num_hidden_layers=layers, vocab_size=512, torch_dtype=dtype)
    if moe:
        cfg.update(num_local_experts=4, num_experts_per_tok=2,
                   sliding_window=None)
    cfg["engine"].update(max_context=256, chunk_size=32, max_batch_tokens=128,
                         max_batch_requests=16, capacity_tokens=8192)
    cfg["check"] = {"sample_tokens": 40,
                    "limits": limits or {"gap_max": 0.05, "gap_mean": 0.005}}
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH_DIR / "traffic" / "toolbench-mistral.json")
                     .read_text())
    mix.update(rate_rps=20, warm_seconds=1, after_seconds=5,
               output={"mean": 6, "std": 2, "min": 2, "max": 12})
    mix["segments"] = [
        {"share": "all", "len": 40},
        {"share": "pick", "variants": 8,
         "len": {"mean": 60, "std": 20, "min": 10, "max": 100}},
        {"share": "unique", "len": {"mean": 20, "std": 8, "min": 4,
                                    "max": 40}}]
    (bench / "traffic" / "tiny-tb.json").write_text(json.dumps(mix))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["workloads"] = [{"name": "tiny.tb", "config": "tiny",
                       "traffic": "tiny-tb", "chips": chips, "why": "a test"}]
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.tb"]
    b["per_layer"].append({"name": "tokens_per_step", "unit": "tokens/step",
                           "better": "higher", "source": "program_span",
                           "layer": "engine step", "moves": "tpot_p50_ms"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp


def run(tmp: Path, seed=11, trace=False, seconds=2):
    cell = load_cell("tiny.tb", root=tmp, bench_dir=tmp / "bench")
    return C.run(cell, seed, seconds, trace, time.perf_counter(),
                 device="cpu")
