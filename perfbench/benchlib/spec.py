"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix and lists the per-layer metrics. Each piece
is a file of its own under the benchmark's folder, found by that name:

  configs/<config>.json        sizes of one model configuration, the
                               engine it is served with and its init
  reference/<reference>.py     a plain float32 forward, named by the
                               configuration's ``"reference"`` key
  traffic/<traffic>.json       parameters of one traffic mix
  metrics/<metric>.py          a reader of one per-layer metric

A later change adds a cell, a configuration, a traffic mix or a metric by
adding files and entries; nothing here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Metric:
    name: str
    unit: str
    source: str
    layer: str
    moves: str
    workloads: Optional[List[str]]
    read: Callable[[Any], Optional[float]]


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    reference: Any                      # the configuration's reference module
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Metric]


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import one file of the benchmark by path, under a name of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: Path = ROOT,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files loaded
    from ``bench_dir``."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    config = load_json(bench_dir / "configs" / f"{w['config']}.json")
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    ref_name = config["reference"]
    reference = load_module(bench_dir / "reference" / f"{ref_name}.py",
                            f"benchref_{ref_name.replace('-', '_')}")
    per_layer = []
    for m in bench["per_layer"]:
        if not _applies(m, name):
            continue
        mod = load_module(bench_dir / "metrics" / f"{m['name']}.py",
                          "benchmetric_" + m["name"].replace(".", "_")
                          .replace("-", "_"))
        per_layer.append(Metric(m["name"], m["unit"], m["source"],
                                m["layer"], m["moves"], m.get("workloads"),
                                mod.read))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    return Cell(name, int(w["chips"]), w["config"], w["traffic"], config,
                traffic, reference, e2e, per_layer)
