"""Log-spaced-bucket histograms with percentile estimation.

The CXL tier papers (2306.11227, 2503.22017) make the case that tail
latency — not the mean — is what separates memory tiers, so the metrics
registry needs percentiles that are cheap to record and cheap to merge.
A fixed log-spaced bucket layout gives both: ``record`` is one
``searchsorted``, ``merge`` is one vector add, and any percentile is
reconstructed from cumulative bucket counts with bounded relative error
(at most the bucket width — ~15% at the default 8 buckets/decade).

All histograms built with the same ``(lo, hi, buckets_per_decade)``
share an edge vector and can be merged; merging mismatched layouts
raises.  Values at or below zero land in the underflow bucket, values
above ``hi`` in the overflow bucket; observed ``min``/``max`` are kept
exactly so the extreme percentiles (p0/p100) are not quantized.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

#: default range covers 1 ns .. ~3 h when recording seconds, and
#: 1 B .. 10 TB when recording byte counts — one layout for both uses.
DEFAULT_LO = 1e-9
DEFAULT_HI = 1e4
DEFAULT_BUCKETS_PER_DECADE = 8

_EDGE_CACHE: Dict[Tuple[float, float, int], np.ndarray] = {}


def _edges(lo: float, hi: float, per_decade: int) -> np.ndarray:
    key = (lo, hi, per_decade)
    e = _EDGE_CACHE.get(key)
    if e is None:
        decades = math.log10(hi / lo)
        n = max(1, int(round(decades * per_decade)))
        e = np.logspace(math.log10(lo), math.log10(hi), n + 1)
        _EDGE_CACHE[key] = e
    return e


class Histogram:
    """Mergeable log-bucket histogram of non-negative samples."""

    __slots__ = ("edges", "counts", "count", "sum", "min", "max",
                 "_layout")

    def __init__(self, lo: float = DEFAULT_LO, hi: float = DEFAULT_HI,
                 buckets_per_decade: int = DEFAULT_BUCKETS_PER_DECADE):
        if not (0.0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
        self._layout = (float(lo), float(hi), int(buckets_per_decade))
        self.edges = _edges(*self._layout)
        # counts[0] = underflow (<= lo), counts[-1] = overflow (> hi)
        self.counts = np.zeros(len(self.edges) + 1, dtype=np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- recording -------------------------------------------------
    def record(self, value: float) -> None:
        v = float(value)
        self.counts[int(np.searchsorted(self.edges, v, side="left"))] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def record_many(self, values: Iterable[float]) -> None:
        arr = np.asarray(list(values) if not isinstance(
            values, np.ndarray) else values, dtype=np.float64)
        if arr.size == 0:
            return
        idx = np.searchsorted(self.edges, arr, side="left")
        np.add.at(self.counts, idx, 1)
        self.count += int(arr.size)
        self.sum += float(arr.sum())
        self.min = min(self.min, float(arr.min()))
        self.max = max(self.max, float(arr.max()))

    # -- reading ---------------------------------------------------
    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (0..100) from bucket counts.

        Returns the geometric midpoint of the bucket holding the
        target rank, clamped to the exact observed [min, max].
        """
        if self.count == 0:
            return 0.0
        if q <= 0:
            return self.min
        if q >= 100:
            return self.max
        target = q / 100.0 * self.count
        cum = np.cumsum(self.counts)
        b = int(np.searchsorted(cum, target, side="left"))
        if b == 0:                      # underflow bucket: exact min
            est = self.min
        elif b >= len(self.edges):      # overflow bucket: exact max
            est = self.max
        else:
            est = math.sqrt(self.edges[b - 1] * self.edges[b])
        return min(max(est, self.min), self.max)

    def quantiles(self, qs: Iterable[float]) -> List[float]:
        return [self.percentile(q) for q in qs]

    # -- combining -------------------------------------------------
    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other``'s samples into self (same layout required)."""
        if other._layout != self._layout:
            raise ValueError(
                f"histogram layout mismatch: {self._layout} vs "
                f"{other._layout}")
        self.counts += other.counts
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def copy(self) -> "Histogram":
        h = Histogram(*self._layout)
        h.merge(self)
        return h

    def reset(self) -> None:
        self.counts[:] = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def snapshot(self) -> Dict[str, float]:
        """Uniform summary used by ``Metrics.snapshot()``."""
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
        p50, p90, p99 = self.quantiles((50, 90, 99))
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "min": self.min, "max": self.max,
                "p50": p50, "p90": p90, "p99": p99}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Histogram(count={self.count}, mean={self.mean:.3g}, "
                f"p99={self.percentile(99):.3g})")


def merge_all(hists: Iterable[Optional["Histogram"]]) -> Optional[Histogram]:
    """Merge any number of same-layout histograms into a fresh one."""
    out: Optional[Histogram] = None
    for h in hists:
        if h is None:
            continue
        if out is None:
            out = h.copy()
        else:
            out.merge(h)
    return out
