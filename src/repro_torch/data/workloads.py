"""Generators for the paper's five studied workloads (§2, Appendix A).

Each generator emits token-id sequences with the *structural* sharing of
the real workload (shared system prompts, per-tool instructions, chained
agent steps, per-document questions, parallel program generations) and
lengths matched to Table 1:

  workload        prompt(mean, std)   output(mean, std)  shared%  share-count
  toolbench       (1835, 742)         (43, 16)           85%      ~39
  agent           (2285, 471)         (16, 13)           97%      ~48
  programming     (3871, 1656)        (190, 343)         97%      ~126
  videoqa         (9865, 5976)        (4, 1.5)           88%      ~8.6
  loogle          (23474, 6105)       (16, 9.9)          91%      ~18

Token ids are synthetic (disjoint integer ranges per component), so
prefix relations are exact — which is all the scheduler observes.
``benchmarks/bench_workloads.py`` checks generated statistics against
these targets.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.request import Request


class _TokenAllocator:
    """Disjoint token-id spans so distinct components never collide."""

    def __init__(self, start: int = 1000):
        self._next = start

    def span(self, n: int) -> Tuple[int, ...]:
        out = tuple(range(self._next, self._next + n))
        self._next += n
        return out


def _lens(rng, mean, std, n, lo=1):
    return np.maximum(rng.normal(mean, std, n), lo).astype(int)


# ---------------------------------------------------------------------
# the five generators
# ---------------------------------------------------------------------

def gen_toolbench(n: int, seed: int = 0, n_tools: int = 64,
                  zipf: float = 0.0,
                  popularity_shift: bool = False) -> List[Request]:
    """system prompt + per-tool instructions + unique question.

    ``popularity_shift``: halfway through, the Zipf ranking rotates so a
    previously-cold tool becomes the hot one — the load-shift scenario
    Preble's post-assignment rebalancing/autoscaling exists for (a
    prefix placed when cold suddenly draws a flash crowd)."""
    rng = np.random.default_rng(seed)
    alloc = _TokenAllocator()
    system = alloc.span(430)
    tools = [alloc.span(int(l)) for l in _lens(rng, 1130, 420, n_tools, 200)]
    if zipf > 0:
        w = 1.0 / np.arange(1, n_tools + 1) ** zipf
        w = w / w.sum()
        if popularity_shift:
            first = rng.choice(n_tools, n // 2, p=w)
            second = rng.choice(n_tools, n - n // 2,
                                p=np.roll(w, n_tools // 2))
            tool_ids = np.concatenate([first, second])
        else:
            tool_ids = rng.choice(n_tools, n, p=w)
    else:
        tool_ids = rng.integers(0, n_tools, n)
    qlens = _lens(rng, 275, 120, n, 16)
    outs = _lens(rng, 43, 16, n, 2)
    return [Request(tokens=system + tools[tool_ids[i]]
                    + alloc.span(int(qlens[i])),
                    max_new_tokens=int(outs[i]), workload="toolbench")
            for i in range(n)]


def gen_agent(n: int, seed: int = 0) -> List[Request]:
    """Embodied agent: chained steps — step k's prompt extends step k-1's
    prompt + generated action + environment observation."""
    rng = np.random.default_rng(seed)
    alloc = _TokenAllocator()
    reqs: List[Request] = []
    env = alloc.span(1700)                       # env + task demonstration
    while len(reqs) < n:
        task = env + alloc.span(int(rng.integers(100, 260)))
        ctx = task
        steps = int(rng.integers(3, 9))
        for _ in range(steps):
            out = int(np.clip(rng.normal(16, 13), 2, 80))
            reqs.append(Request(tokens=ctx, max_new_tokens=out,
                                workload="agent"))
            obs = alloc.span(int(rng.integers(20, 90)))
            ctx = ctx + alloc.span(out) + obs    # action + observation
            if len(reqs) >= n:
                break
    return reqs


def gen_programming(n: int, seed: int = 0) -> List[Request]:
    """Code demo system prompt shared by all; problem shared by its
    parallel generations (best-of-k sampling)."""
    rng = np.random.default_rng(seed)
    alloc = _TokenAllocator()
    system = alloc.span(2100)                    # code example demonstration
    reqs: List[Request] = []
    while len(reqs) < n:
        problem = alloc.span(int(np.clip(rng.normal(1770, 1600), 150, 9000)))
        k = int(rng.integers(3, 9))              # parallel generations
        for _ in range(k):
            out = int(np.clip(rng.normal(190, 343), 8, 2048))
            reqs.append(Request(tokens=system + problem,
                                max_new_tokens=out, workload="programming"))
            if len(reqs) >= n:
                break
    return reqs


def gen_videoqa(n: int, seed: int = 0) -> List[Request]:
    """Tokenized video (long) + multiple-choice question (short)."""
    rng = np.random.default_rng(seed)
    alloc = _TokenAllocator()
    reqs: List[Request] = []
    while len(reqs) < n:
        video = alloc.span(int(np.clip(rng.normal(9800, 5900), 1500, 40000)))
        k = max(int(rng.normal(8.6, 2.0)), 1)
        for _ in range(k):
            q = alloc.span(int(rng.integers(30, 100)))
            out = int(np.clip(rng.normal(4, 1.5), 1, 10))
            reqs.append(Request(tokens=video + q, max_new_tokens=out,
                                workload="videoqa"))
            if len(reqs) >= n:
                break
    return reqs


def gen_loogle(n: int, seed: int = 0) -> List[Request]:
    """13-token system prompt + long document + question."""
    rng = np.random.default_rng(seed)
    alloc = _TokenAllocator()
    system = alloc.span(13)
    reqs: List[Request] = []
    while len(reqs) < n:
        doc = alloc.span(int(np.clip(rng.normal(22900, 6000), 4000, 60000)))
        k = max(int(rng.normal(8.6, 3.0)), 1)
        for _ in range(k):
            q = alloc.span(int(rng.integers(200, 700)))
            out = int(np.clip(rng.normal(16, 9.9), 1, 60))
            reqs.append(Request(tokens=system + doc + q,
                                max_new_tokens=out, workload="loogle"))
            if len(reqs) >= n:
                break
    return reqs


WORKLOADS = {
    "toolbench": gen_toolbench,
    "agent": gen_agent,
    "programming": gen_programming,
    "videoqa": gen_videoqa,
    "loogle": gen_loogle,
}


def gen_workload(name: str, n: int, seed: int = 0, **kw) -> List[Request]:
    return WORKLOADS[name](n, seed=seed, **kw)


# ---------------------------------------------------------------------
# statistics (Table 1 check)
# ---------------------------------------------------------------------

@dataclass
class WorkloadStats:
    prompt_mean: float
    prompt_std: float
    output_mean: float
    output_std: float
    shared_frac: float          # mean fraction of prompt shared w/ >=1 other
    share_count: float          # mean #requests sharing a request's prefix


def workload_stats(requests: Sequence[Request]) -> WorkloadStats:
    """Computed the way the paper does: build an (infinite-cache) prefix
    tree over the whole dataset and measure per-request sharing."""
    from ..core.radix_tree import RadixTree
    tree = RadixTree()
    for i, r in enumerate(requests):
        tree.insert(r.tokens, instance=i)
    plens = np.array([r.prompt_len for r in requests], float)
    olens = np.array([r.max_new_tokens for r in requests], float)
    shared, counts = [], []
    for i, r in enumerate(requests):
        m = tree.match(r.tokens)
        s = 0
        # "key portion": the deepest node on the path with more tokens
        # than the sum of its predecessors (paper App. A definition);
        # share_count = #requests sharing that key portion.
        key_count, prefix_sum = 1, 0
        for node in m.path:
            n_share = len(node.instances)
            if n_share > 1:
                s += len(node.tokens)
            if len(node.tokens) > prefix_sum:
                key_count = n_share
            prefix_sum += len(node.tokens)
        shared.append(s / max(r.prompt_len, 1))
        counts.append(key_count)
    return WorkloadStats(
        prompt_mean=float(plens.mean()), prompt_std=float(plens.std()),
        output_mean=float(olens.mean()), output_std=float(olens.std()),
        shared_frac=float(np.mean(shared)),
        share_count=float(np.mean(counts)))
