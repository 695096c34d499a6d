"""The one traffic generator against the paper's Table 1 and its own
promises: a seed repeats, seeds share their shapes, requests fit."""

import json

import numpy as np
import pytest

from benchlib import traffic
from benchlib.spec import BENCH_DIR


def _mix(name):
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def _shared_frac(prompts):
    """Per request, the longest prefix it shares with any other request,
    over its length (the paper's shared share of a prompt)."""
    order = sorted(range(len(prompts)), key=lambda i: prompts[i])
    best = [0] * len(prompts)

    def lcp(a, b):
        n = min(len(a), len(b))
        k = 0
        while k < n and a[k] == b[k]:
            k += 1
        return k

    for x, y in zip(order, order[1:]):
        k = lcp(prompts[x], prompts[y])
        best[x], best[y] = max(best[x], k), max(best[y], k)
    return float(np.mean([b / len(p) for b, p in zip(best, prompts)]))


def _window(mix, seed, n=1200):
    """About n requests of the mix's window."""
    seconds = n / mix["rate_rps"]
    return [p for p in traffic.plan(mix, seed, seconds, 32000, 4096)
            if p.phase == "window"]


@pytest.mark.parametrize("mix", ["toolbench-mistral", "toolbench-mixtral"])
def test_toolbench_matches_table_1(mix):
    reqs = _window(_mix(mix), 5)
    plen = np.array([len(p.tokens) for p in reqs])
    out = np.array([p.max_new for p in reqs])
    assert len(reqs) > 500
    assert abs(plen.mean() - 1835) < 0.05 * 1835
    assert abs(out.mean() - 43) < 0.08 * 43
    assert abs(out.std() - 16) < 0.2 * 16
    assert abs(_shared_frac([p.tokens for p in reqs]) - 0.85) < 0.04


def test_short_shares_nothing():
    reqs = _window(_mix("short-mistral"), 5)
    plen = np.array([len(p.tokens) for p in reqs])
    assert abs(plen.mean() - 275) < 0.05 * 275
    assert _shared_frac([p.tokens for p in reqs]) < 0.01


@pytest.mark.parametrize("mix", ["toolbench-mistral", "short-mistral"])
def test_a_seed_repeats_and_seeds_share_shapes(mix):
    m = _mix(mix)
    seed = 2 ** 31 + 12345          # a driver's seed can pass 32 bits
    a = traffic.plan(m, seed, 30, 32000, 4096)
    b = traffic.plan(m, seed, 30, 32000, 4096)
    c = traffic.plan(m, 7, 30, 32000, 4096)
    assert [(p.due, p.tokens, p.max_new, p.phase) for p in a] == \
        [(p.due, p.tokens, p.max_new, p.phase) for p in b]
    # another seed: the same trace of arrivals and lengths, other tokens
    assert [(p.due, len(p.tokens), p.max_new, p.phase) for p in a] == \
        [(p.due, len(p.tokens), p.max_new, p.phase) for p in c]
    assert [p.tokens for p in a] != [p.tokens for p in c]
    win = [p for p in a if p.phase == "window"]
    assert all(m["warm_seconds"] <= p.due < m["warm_seconds"] + 30
               for p in win)
    assert all(0 <= t < 32000 for p in a for t in p.tokens)


def test_a_request_beyond_max_context_is_refused():
    with pytest.raises(ValueError, match="max_context"):
        traffic.plan(_mix("toolbench-mistral"), 1, 30, 32000, 2048)


def test_bursty_arrivals_keep_the_mean_rate():
    m = dict(_mix("short-mistral"), arrivals={"kind": "lognormal",
                                              "sigma": 1.0})
    reqs = _window(m, 3)
    seconds = 1200 / m["rate_rps"]
    assert abs(len(reqs) / seconds - m["rate_rps"]) < 0.2 * m["rate_rps"]


def test_prime_holds_every_tool_prefix_once():
    m = _mix("toolbench-mistral")
    plan = traffic.plan(m, 9, 30, 32000, 4096)
    prime = [p for p in plan if p.phase == "prime"]
    assert len(prime) == 64 and all(p.max_new == 1 for p in prime)
    heads = {p.tokens for p in prime}
    assert len(heads) == 64
    win = [p for p in plan if p.phase == "window"]
    # every window prompt starts with one primed prefix
    assert all(any(p.tokens[:len(h)] == h for h in heads) for p in win)
    assert not [p for p in traffic.plan(_mix("short-mistral"), 9, 30, 32000,
                                        4096) if p.phase == "prime"]
