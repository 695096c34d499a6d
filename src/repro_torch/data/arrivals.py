"""Request arrival processes (paper §4.2 + Appendix A.6).

* Poisson at a target RPS — the paper's main methodology.
* Azure-like bursty arrivals: the trace shows inter-arrival times from
  2 microseconds to 217 seconds at ~5-7 req/s means. A lognormal
  inter-arrival process with high sigma reproduces that heavy tail.
* Zipf popularity helper for skewed prompt reuse (Figure 5 ablation).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..core.request import Request


def poisson_arrivals(n: int, rps: float, seed: int = 0,
                     start: float = 0.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rps, n)
    return start + np.cumsum(gaps)


def azure_burst_arrivals(n: int, rps: float, seed: int = 0,
                         sigma: float = 2.2, start: float = 0.0
                         ) -> np.ndarray:
    """Lognormal inter-arrivals calibrated to mean 1/rps with the Azure
    trace's heavy tail (micro-second bursts to multi-minute gaps)."""
    rng = np.random.default_rng(seed)
    mu = np.log(1.0 / rps) - sigma ** 2 / 2.0     # mean = 1/rps
    gaps = rng.lognormal(mu, sigma, n)
    return start + np.cumsum(gaps)


def assign_arrivals(requests: Sequence[Request], times: np.ndarray,
                    shuffle: bool = True, seed: int = 0) -> List[Request]:
    """Attach arrival times; shuffling decorrelates generation order
    (e.g. consecutive questions on one video) from arrival order —
    except chained-agent steps, which must stay causally ordered."""
    reqs = list(requests)
    rng = np.random.default_rng(seed)
    if shuffle and not any(r.workload == "agent" for r in reqs):
        rng.shuffle(reqs)
    for r, t in zip(reqs, sorted(times[:len(reqs)])):
        r.arrival_time = float(t)
    return reqs


def zipf_choice(n_items: int, n_draws: int, alpha: float = 1.1,
                seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_items + 1) ** alpha
    return rng.choice(n_items, n_draws, p=w / w.sum())
