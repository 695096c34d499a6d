"""The one traffic generator: open-loop arrivals of prompts built from
shared and unique segments, read from a traffic mix's parameters.

A rewritten copy of the structure of the paper's synthetic generators
(``gen_toolbench`` and its siblings): a prompt is a concatenation of
segments, each either the same for every request (a system prompt), one
of a few variants picked per request (a tool's instructions, a document)
or unique to the request (a question). Output lengths and arrival gaps
come from the mix too. Token ids are drawn over the model's vocabulary,
so prefix relations are exact and every id can be embedded.

Run-to-run steadiness: the *shapes* of a run (every segment length, the
variant each request picks, every output length and every arrival time)
are drawn from the mix's ``shape_seed``: one realisation of the mix,
replayed by every run as a recorded trace would be. The run's ``--seed``
draws every token id (and the weights), so two seeds serve the same
work with other tokens. Runs whose seeds also reordered the requests
spread three to ten times wider on the chip than two runs of one seed
(PERF.md).

A run has three timed phases, on one clock whose 0 is the start of the
warm phase: ``warm`` (``warm_seconds`` of traffic that brings the load to
its steady state and warms the shapes, part of set-up), ``window`` (the
measured requests, due in [warm_seconds, warm_seconds + seconds)) and
``after`` (load that keeps coming while the window's last requests
finish; never measured). With ``"prime": true`` a ``prime`` phase comes
first, outside the clock: one request a variant of each picked segment
(its shared prefix, one output token), served to the end, so the radix
cache holds every shared prefix as a long-running deployment's would.

Mix parameters (``traffic/<name>.json``):
  rate_rps        mean arrival rate
  arrivals        "poisson", or {"kind": "lognormal", "sigma": s} (bursty,
                  same mean rate)
  warm_seconds, after_seconds
  shape_seed
  segments        [{"share": "all" | "pick" | "unique", "len": L or
                  {"mean", "std", "min", "max"}, "variants": n (pick,
                  each request picks one uniformly)}]
  output          {"mean", "std", "min", "max"}
  prime           true: fill the cache with every shared prefix first
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

PHASES = ("warm", "window", "after")


@dataclass
class Planned:
    due: float                  # seconds after the start of the warm phase
    tokens: Tuple[int, ...]
    max_new: int
    phase: str


def _length(rng, spec, n: int) -> np.ndarray:
    if isinstance(spec, (int, float)):
        return np.full(n, int(spec))
    x = rng.normal(spec["mean"], spec.get("std", 0.0), n)
    return np.clip(x, spec.get("min", 1), spec.get("max", 1 << 30)
                   ).astype(int)


def _gaps(rng, arrivals, rate: float, length: float) -> np.ndarray:
    """Inter-arrival gaps whose running sum stays inside ``length``."""
    gaps: List[float] = []
    total = 0.0
    while True:
        if arrivals == "poisson":
            g = rng.exponential(1.0 / rate)
        elif arrivals.get("kind") == "lognormal":
            sigma = arrivals["sigma"]
            g = rng.lognormal(np.log(1.0 / rate) - sigma ** 2 / 2.0, sigma)
        else:
            raise ValueError(f"unknown arrivals {arrivals!r}")
        if total + g >= length:
            return np.array(gaps)
        total += g
        gaps.append(g)


def plan(mix: Dict[str, Any], seed: int, seconds: float, vocab: int,
         max_context: int) -> List[Planned]:
    """Every request of a run, sorted by due time."""
    shape_seed = int(mix["shape_seed"])
    segs = mix["segments"]
    rate = float(mix["rate_rps"])
    arrivals = mix.get("arrivals", "poisson")
    lengths = {"warm": float(mix["warm_seconds"]), "window": float(seconds),
               "after": float(mix["after_seconds"])}
    tok_rng = np.random.default_rng([seed, 1])

    def tokens(n: int) -> Tuple[int, ...]:
        return tuple(int(t) for t in tok_rng.integers(0, vocab, n))

    # the segments' fixed contents: one for "all", n variants for "pick"
    var_rng = np.random.default_rng([shape_seed, 99])
    variants: List[Sequence[Tuple[int, ...]]] = []
    for s in segs:
        if s["share"] == "all":
            variants.append([tokens(int(_length(var_rng, s["len"], 1)[0]))])
        elif s["share"] == "pick":
            variants.append([tokens(int(n)) for n in
                             _length(var_rng, s["len"], s["variants"])])
        elif s["share"] == "unique":
            variants.append([])
        else:
            raise ValueError(f"unknown segment share {s['share']!r}")

    out: List[Planned] = []
    if mix.get("prime"):
        head: Tuple[int, ...] = ()
        for s, v in zip(segs, variants):
            if s["share"] == "pick":
                out.extend(Planned(0.0, head + x, 1, "prime") for x in v)
            if s["share"] != "all":
                break
            head += v[0]
    start = 0.0
    for k, phase in enumerate(PHASES):
        srng = np.random.default_rng([shape_seed, k])
        gaps = _gaps(srng, arrivals, rate, lengths[phase])
        n = len(gaps)
        picks = [srng.integers(0, len(v), n) if s["share"] == "pick"
                 else None for s, v in zip(segs, variants)]
        uniq = [_length(srng, s["len"], n) if s["share"] == "unique"
                else None for s in segs]
        outs = _length(srng, mix["output"], n)
        due = start + np.cumsum(gaps)
        for j in range(n):
            prompt: Tuple[int, ...] = ()
            for s, v, p, u in zip(segs, variants, picks, uniq):
                if s["share"] == "all":
                    prompt += v[0]
                elif s["share"] == "pick":
                    prompt += v[p[j]]
                else:
                    prompt += tokens(int(u[j]))
            if len(prompt) + int(outs[j]) > max_context:
                raise ValueError(
                    f"a request of {len(prompt)} + {int(outs[j])} tokens "
                    f"exceeds max_context {max_context}: clip the mix")
            out.append(Planned(float(due[j]), prompt, int(outs[j]), phase))
        start += lengths[phase]
    out.sort(key=lambda p: p.due)
    return out
