"""Unified metrics registry for the LMB framework.

One registry, three instrument kinds, one ``snapshot()``:

  * **tier counters** — the original per-consumer hit/miss/byte
    accounting (hit ratios, locality claims, §4.1.2);
  * **counters / gauges** — monotonic counts and last-write-wins
    values (journal length, shed requests, ...);
  * **histograms** — log-bucket latency/size distributions
    (``repro_torch.obs.hist``) with p50/p90/p99 in the snapshot, the
    percentile machinery the serve harness reports TTFT and
    inter-token gaps against.

``snapshot()`` schema (every key always present)::

    {"tiers":      {consumer: {tier: {hits, misses, bytes_hit,
                                      bytes_missed, bytes_in,
                                      bytes_out, accesses}}},
     "counters":   {name: float},
     "gauges":     {name: float},
     "histograms": {name: {count, sum, mean, min, max, p50, p90, p99}},
     "events":     {count, capacity, total}}

Registries are mergeable: workers record into private ``Metrics`` and
``merge()`` them into ``GLOBAL_METRICS``.  The event log is bounded by
the same ring cap as the span tracer, so a long-lived registry cannot
grow without bound.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Deque, Dict, Tuple

from repro_torch.obs.hist import Histogram
from repro_torch.obs.trace import DEFAULT_RING_CAPACITY


@dataclasses.dataclass
class TierCounters:
    hits: int = 0
    misses: int = 0
    bytes_hit: int = 0     # bytes served from this tier on hits
    bytes_missed: int = 0  # bytes requested that missed this tier
    bytes_in: int = 0      # bytes paged INTO this tier
    bytes_out: int = 0     # bytes paged OUT of this tier
    accesses: int = 0

    @property
    def hit_ratio(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def merge(self, other: "TierCounters") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


class Metrics:
    """Unified registry: tier counters + counters + gauges + hists."""

    def __init__(self, max_events: int = DEFAULT_RING_CAPACITY) -> None:
        self._by_consumer: Dict[str, Dict[str, TierCounters]] = defaultdict(
            lambda: defaultdict(TierCounters))
        self._events: Deque[Tuple[float, str, str]] = deque(
            maxlen=max_events)
        self._events_total = 0
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}
        self._t0 = time.monotonic()

    # -- tier counters ---------------------------------------------
    def tier(self, consumer: str, tier_name: str) -> TierCounters:
        return self._by_consumer[consumer][tier_name]

    def record_hit(self, consumer: str, tier_name: str,
                   nbytes: int = 0) -> None:
        c = self.tier(consumer, tier_name)
        c.hits += 1
        c.accesses += 1
        c.bytes_hit += nbytes

    def record_miss(self, consumer: str, tier_name: str,
                    nbytes: int = 0) -> None:
        c = self.tier(consumer, tier_name)
        c.misses += 1
        c.accesses += 1
        c.bytes_missed += nbytes

    def record_move(self, consumer: str, src: str, dst: str,
                    nbytes: int) -> None:
        self.tier(consumer, src).bytes_out += nbytes
        self.tier(consumer, dst).bytes_in += nbytes

    # -- counters / gauges / histograms ----------------------------
    def inc(self, name: str, value: float = 1.0) -> None:
        self._counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        self._gauges[name] = float(value)

    def hist(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram()
        return h

    def observe(self, name: str, value: float) -> None:
        self.hist(name).record(value)

    # -- event log (bounded) ---------------------------------------
    def event(self, consumer: str, what: str) -> None:
        self._events.append((time.monotonic() - self._t0, consumer, what))
        self._events_total += 1

    # -- combining -------------------------------------------------
    def merge(self, other: "Metrics") -> "Metrics":
        """Fold another registry's samples into this one.

        Tier counters and counters add; gauges take ``other``'s value
        (last write wins); histograms merge bucket-wise; events append
        (still bounded by this registry's cap).
        """
        for consumer, tiers in other._by_consumer.items():
            for tname, c in tiers.items():
                self.tier(consumer, tname).merge(c)
        for name, v in other._counters.items():
            self._counters[name] += v
        self._gauges.update(other._gauges)
        for name, h in other._hists.items():
            self.hist(name).merge(h)
        self._events.extend(other._events)
        self._events_total += other._events_total
        return self

    # -- reading ---------------------------------------------------
    def snapshot(self) -> Dict[str, dict]:
        return {
            "tiers": {
                consumer: {t: dataclasses.asdict(c)
                           for t, c in tiers.items()}
                for consumer, tiers in self._by_consumer.items()
            },
            "counters": dict(self._counters),
            "gauges": dict(self._gauges),
            "histograms": {n: h.snapshot()
                           for n, h in self._hists.items()},
            "events": {"count": len(self._events),
                       "capacity": self._events.maxlen,
                       "total": self._events_total},
        }

    def reset(self) -> None:
        self._by_consumer.clear()
        self._events.clear()
        self._events_total = 0
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()


#: process-global default registry (consumers may also own private ones)
GLOBAL_METRICS = Metrics()
