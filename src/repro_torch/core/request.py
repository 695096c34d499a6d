"""Request lifecycle objects shared by schedulers, engines and simulator."""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

_req_ids = itertools.count()


class RequestState(enum.Enum):
    QUEUED_GLOBAL = "queued_global"
    QUEUED_LOCAL = "queued_local"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    FAILED = "failed"


@dataclass
class Request:
    tokens: Tuple[int, ...]                 # prompt token ids
    max_new_tokens: int = 32
    arrival_time: float = 0.0
    request_id: int = field(default_factory=lambda: next(_req_ids))
    workload: str = ""                      # tag for mixed-workload stats

    # -- filled in by schedulers / engines --
    state: RequestState = RequestState.QUEUED_GLOBAL
    instance: Optional[int] = None
    cached_len: int = 0                     # prefix tokens found cached
    device_cached_len: int = 0              # ... of which device-resident
    restored_len: int = 0                   # host-tier tokens restored
    prefetched_len: int = 0                 # host-tier tokens whose restore
                                            # a schedule-time prefetch moved
                                            # OFF this request's TTFT path
    migrated_len: int = 0                   # tokens shipped host->host to
                                            # the serving instance's tier
    prefill_done: int = 0                   # prompt tokens prefilled so far
    output_tokens: List[int] = field(default_factory=list)
    retries: int = 0                        # re-route attempts consumed
    # timeline
    scheduled_time: float = 0.0             # global scheduler decision
    first_run_time: float = 0.0             # first iteration on an engine
    first_token_time: float = 0.0
    finish_time: float = 0.0
    # telemetry span timeline (serving.telemetry.RequestTrace), attached
    # only when a Telemetry-enabled runtime submits the request. Typed
    # Any (duck-typed here) so core never imports the serving layer.
    trace: Optional[Any] = None

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)

    @property
    def missed_len(self) -> int:
        return max(self.prompt_len - self.cached_len, 0)

    def reset_for_retry(self, now: Optional[float] = None) -> None:
        """Scrub every placement-scoped field before re-routing to a
        new instance. A retried request must look freshly arrived to
        the global scheduler: stale `migrated_len` / `prefetched_len` /
        partial outputs from a dead placement would corrupt both the
        E2 cost model and the accounting invariants — and a stale
        `finish_time` would mix the dead attempt's terminal stamp into
        the retried attempt's latency attribution."""
        self.state = RequestState.QUEUED_GLOBAL
        self.instance = None
        self.cached_len = 0
        self.device_cached_len = 0
        self.restored_len = 0
        self.prefetched_len = 0
        self.migrated_len = 0
        self.prefill_done = 0
        self.output_tokens = []
        self.scheduled_time = 0.0
        self.first_run_time = 0.0
        self.first_token_time = 0.0
        self.finish_time = 0.0
        if self.trace is not None:
            # close the dead attempt's spans with an error status and
            # mark the retry; callers without a clock (drain paths) get
            # the timeline's last known time. Drain + reroute both
            # reset: dedupe so one actual retry stamps one event.
            t = now if now is not None else self.trace.last_t
            self.trace.close_open(t, status="error")
            evs = self.trace.events
            if not evs or evs[-1]["name"] != "retry":
                self.trace.point("retry", t, attempt=self.retries + 1)

    def latency(self) -> float:
        return self.finish_time - self.arrival_time

    def ttft(self) -> float:
        return self.first_token_time - self.arrival_time
