"""Deterministic fault injection for the tiered cluster (DESIGN.md §11).

Production Preble must survive a lossy control plane: instances crash
mid-wave, DMA transfers (demote, restore, prefetch, migration) fail or
land partially, eviction notifications drop or arrive late, and
heartbeats go missing. This module is the single source of those
events: a seed-driven ``FaultInjector`` that the runtimes
(``ClusterRuntime``, ``Engine``, ``PagedHostTier``, ``Simulator``)
consult at each fault point.

Design rules:

  * DETERMINISTIC AND SITE-INDEPENDENT: every fault site draws from its
    own ``numpy`` Generator seeded by (seed, site) — toggling one
    site's rate can never shift another site's draw sequence, so chaos
    runs are reproducible and bisectable.
  * ZERO-COST WHEN OFF: nothing here is consulted unless a runtime was
    built with a ``FaultConfig``; engines keep ``faults = None`` and
    every hook is behind an ``is not None`` check.
  * CRASHES ARE SILENT: an injected crash raises ``InstanceCrashed``
    from inside the engine's step — the control plane learns about it
    only through the heartbeat detector (or immediately, when detection
    is disabled and the oracle fallback recovers on the spot).

``CircuitBreaker`` is the degradation half: repeated restore/prefetch
DMA failures open the breaker and the engine serves by recompute for a
cooldown instead of thrashing the failing path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


class InstanceCrashed(RuntimeError):
    """Raised from inside ``Engine.step`` when an armed crash fires —
    the data plane dies mid-step, with prefetch reservations and demote
    DMA possibly in flight. Only the cluster runtime catches it."""

    def __init__(self, instance_id: int):
        super().__init__(f"instance {instance_id} crashed")
        self.instance_id = instance_id


@dataclass
class FaultConfig:
    """Fault schedule + rates. All rates default to 0 (no faults)."""

    seed: int = 0
    # instance_id -> virtual time at which it crashes
    crash_at: Dict[int, float] = field(default_factory=dict)
    # arm the crash to fire INSIDE the instance's next step (after
    # admissions and prefetch issue — DMA in flight), rather than
    # between steps
    crash_mid_step: bool = True
    # blanket DMA failure probability; per-site overrides win
    dma_failure_rate: float = 0.0
    dma_rates: Dict[str, float] = field(default_factory=dict)
    # eviction-notification loss / delay
    notify_drop_rate: float = 0.0
    notify_delay_rate: float = 0.0
    notify_delay: float = 0.0           # seconds, when delayed
    # heartbeat loss (exercises ALIVE->SUSPECT->ALIVE recovery)
    heartbeat_drop_rate: float = 0.0
    # instance_id -> slowdown factor (>1 = straggler: the cluster steps
    # the engine every factor-th tick; the simulator folds it into
    # iteration time)
    straggle: Dict[int, float] = field(default_factory=dict)


# Stable site ids: seeds are (config.seed, _SITE_IDS[site]), so adding
# a new site NEVER reshuffles existing streams. Append only.
_SITE_IDS = {
    "dma.demote": 1,
    "dma.restore": 2,
    "dma.prefetch": 3,
    "dma.migrate": 4,
    "dma.partial": 5,
    "notify.drop": 6,
    "notify.delay": 7,
    "heartbeat.drop": 8,
}


class FaultInjector:
    """Runtime half of the fault model: deterministic draws per site
    plus the crash schedule. One injector is shared by a whole cluster
    (sites are keyed by kind, not instance — the schedule already pins
    which instance crashes)."""

    DMA_SITES = ("demote", "restore", "prefetch", "migrate")

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self._streams: Dict[str, np.random.Generator] = {}
        # (time, instance) schedule, earliest first, popped as due
        self._crash_sched: List[Tuple[float, int]] = sorted(
            (t, i) for i, t in cfg.crash_at.items())
        self._armed: set = set()
        self.stats = {f"dma_{s}_failures": 0 for s in self.DMA_SITES}
        self.stats.update({"crashes": 0, "notify_dropped": 0,
                           "notify_delayed": 0, "heartbeat_dropped": 0})

    def _stream(self, site: str) -> np.random.Generator:
        g = self._streams.get(site)
        if g is None:
            g = np.random.default_rng(
                [self.cfg.seed & 0x7FFFFFFF, _SITE_IDS[site]])
            self._streams[site] = g
        return g

    # ---- DMA transfer failures --------------------------------------------

    def dma_fails(self, site: str) -> bool:
        """One draw for one transfer at ``site`` (demote | restore |
        prefetch | migrate). True = the transfer is lost."""
        rate = self.cfg.dma_rates.get(site, self.cfg.dma_failure_rate)
        if rate <= 0.0:
            return False
        hit = bool(self._stream(f"dma.{site}").random() < rate)
        if hit:
            self.stats[f"dma_{site}_failures"] += 1
        return hit

    def partial_keep(self, n: int) -> int:
        """How many leading pieces of an n-piece transfer survive a
        partial failure: uniform 0..n-1 (a prefix stays contiguous and
        therefore ingestible; 0 = total loss)."""
        if n <= 0:
            return 0
        return int(self._stream("dma.partial").integers(0, n))

    # ---- eviction-notification loss / delay --------------------------------

    def drop_notify(self) -> bool:
        if self.cfg.notify_drop_rate <= 0.0:
            return False
        hit = bool(self._stream("notify.drop").random()
                   < self.cfg.notify_drop_rate)
        if hit:
            self.stats["notify_dropped"] += 1
        return hit

    def notify_delay(self) -> float:
        """Seconds to delay this notification (0 = deliver now)."""
        if self.cfg.notify_delay_rate <= 0.0 or self.cfg.notify_delay <= 0.0:
            return 0.0
        if self._stream("notify.delay").random() < self.cfg.notify_delay_rate:
            self.stats["notify_delayed"] += 1
            return self.cfg.notify_delay
        return 0.0

    # ---- heartbeat loss ----------------------------------------------------

    def drop_heartbeat(self) -> bool:
        if self.cfg.heartbeat_drop_rate <= 0.0:
            return False
        hit = bool(self._stream("heartbeat.drop").random()
                   < self.cfg.heartbeat_drop_rate)
        if hit:
            self.stats["heartbeat_dropped"] += 1
        return hit

    # ---- crash schedule ----------------------------------------------------

    def crashes_due(self, now: float) -> List[int]:
        """Pop and return every instance whose scheduled crash time has
        arrived."""
        due: List[int] = []
        while self._crash_sched and self._crash_sched[0][0] <= now:
            _, inst = self._crash_sched.pop(0)
            due.append(inst)
        return due

    def next_crash_time(self) -> Optional[float]:
        return self._crash_sched[0][0] if self._crash_sched else None

    def arm_crash(self, instance_id: int) -> None:
        """Arm a mid-step crash: the engine raises ``InstanceCrashed``
        at its in-step fault point on its next step."""
        self._armed.add(instance_id)

    def take_crash(self, instance_id: int) -> bool:
        """Engine-side: consume an armed crash for this instance."""
        if instance_id in self._armed:
            self._armed.discard(instance_id)
            self.stats["crashes"] += 1
            return True
        return False

    def record_crash(self, instance_id: int) -> None:
        """Count a crash realized outside the mid-step path (between
        steps, or in the simulator's event loop)."""
        self.stats["crashes"] += 1

    def straggle_factor(self, instance_id: int) -> float:
        return max(self.cfg.straggle.get(instance_id, 1.0), 1.0)


@dataclass
class CircuitBreaker:
    """Per-instance breaker over the host-tier restore/prefetch path:
    ``threshold`` consecutive DMA failures open it for ``cooldown``
    virtual seconds, during which the engine plans no restores and no
    prefetches (admission degrades to recompute) instead of thrashing
    the failing path. Any success closes the failure streak."""

    threshold: int = 3
    cooldown: float = 1.0
    consecutive: int = 0
    open_until: float = float("-inf")
    trips: int = 0

    def allow(self, now: float) -> bool:
        return now >= self.open_until

    def record_failure(self, now: float) -> None:
        self.consecutive += 1
        if self.consecutive >= self.threshold:
            self.open_until = now + self.cooldown
            self.consecutive = 0
            self.trips += 1

    def record_success(self) -> None:
        self.consecutive = 0
