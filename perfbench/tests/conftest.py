"""The benchmark's CPU tests: ``python -m pytest perfbench/tests`` from
the root of the checkout (card tests: ``-m cuda``)."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
