"""Nothing the benchmark runs imports JAX, the JAX package or its
benches, by each module's top-level name compared whole (the port's
name begins with the JAX package's); a run without a card prints no
result."""

import ast
import json
import subprocess
import sys

import pytest

from benchlib.spec import BENCH_DIR, ROOT

sys.path.insert(0, str(BENCH_DIR))
import run as R  # noqa: E402

BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _sources():
    return [p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.parts]


def test_no_source_of_the_benchmark_imports_a_banned_name():
    seen = set()
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                seen.add(top)
                assert top not in BANNED, (path, n)
    assert "repro_torch" in seen


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").glob("*.py"):
        tops = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops.add(node.module.split(".")[0])
        assert tops <= {"__future__", "math", "typing", "torch"}, path


def test_the_modules_a_run_loads_hold_no_banned_name():
    """Import everything a run imports, with the banned names blocked."""
    code = f"""
import sys, importlib.abc
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in {sorted(BANNED)!r}:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
sys.path[:0] = [{str(BENCH_DIR)!r}, {str(ROOT / 'src')!r}]
import run
run._env()
from benchlib import cell, check, devtrace, serve  # noqa
from benchlib.spec import load_cell
import repro_torch.serving.cluster, repro_torch.core.request
import repro_torch.models.layers, repro_torch.core.cost_model
import json
for w in json.load(open({str(ROOT / 'BENCHMARK.json')!r}))["workloads"]:
    load_cell(w["name"])
bad = run.loaded_forbidden()
assert not bad, bad
print("clean")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_loaded_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like.x", object())
    assert R.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "repro.serving", object())
    assert R.loaded_forbidden() == ["repro"]


def test_every_cell_names_files_that_exist():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
    for m in b["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()


def test_a_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload",
         "mistral-7b.toolbench", "--seed", "1", "--seconds", "1", "--trace",
         "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert "correct" not in out.stdout
