"""Eviction and prefetch policies for the LinkedBuffer.

The paper's §4.1.2 observes that hot-index locality "considerably dismisses"
the CXL latency penalty — these policies are what creates that locality: the
onboard tier is a cache over the linked tier, and the policy decides which
pages stay onboard.

Policies operate on opaque page keys; the LinkedBuffer calls:
    on_access(key)   every time a page is touched onboard
    victim()         when space is needed — returns the page to demote
    on_insert(key) / on_remove(key)
The Prefetcher issues lookahead hints (sequential and stride detection —
fio-style sequential workloads are the paper's best case).
"""

from __future__ import annotations

import abc
import dataclasses
from collections import OrderedDict, deque
from typing import Dict, Hashable, List, Optional, Sequence, Tuple


class EvictionPolicy(abc.ABC):
    @abc.abstractmethod
    def on_insert(self, key: Hashable) -> None: ...

    @abc.abstractmethod
    def on_access(self, key: Hashable) -> None: ...

    @abc.abstractmethod
    def on_remove(self, key: Hashable) -> None: ...

    @abc.abstractmethod
    def victim(self) -> Optional[Hashable]: ...

    def victims(self, k: int) -> List[Hashable]:
        """Up to ``k`` distinct eviction victims in ONE policy call — the
        bulk-eviction hook for batched faults.  The default reproduces
        ``k`` successive victim()/on_remove() selections without mutating
        residency bookkeeping (chosen keys are temporarily pinned so the
        next victim() pick skips them); policies with cheap ordered state
        may override with a direct scan."""
        chosen: List[Hashable] = []
        pinned = self._pinned()
        try:
            for _ in range(max(k, 0)):
                v = self.victim()
                if v is None:
                    break
                chosen.append(v)
                pinned.add(v)
        finally:
            for v in chosen:
                pinned.discard(v)
        return chosen

    def pin(self, key: Hashable) -> None:
        self._pinned().add(key)

    def unpin(self, key: Hashable) -> None:
        self._pinned().discard(key)

    def _pinned(self) -> set:
        if not hasattr(self, "_pins"):
            self._pins = set()
        return self._pins


class LRU(EvictionPolicy):
    def __init__(self) -> None:
        self._order: "OrderedDict[Hashable, None]" = OrderedDict()

    def on_insert(self, key: Hashable) -> None:
        self._order[key] = None
        self._order.move_to_end(key)

    def on_access(self, key: Hashable) -> None:
        if key in self._order:
            self._order.move_to_end(key)

    def on_remove(self, key: Hashable) -> None:
        self._order.pop(key, None)

    def victim(self) -> Optional[Hashable]:
        for key in self._order:
            if key not in self._pinned():
                return key
        return None

    def victims(self, k: int) -> List[Hashable]:
        # one ordered scan = the first k unpinned keys, exactly what k
        # successive victim()+on_remove() rounds would pick
        pinned = self._pinned()
        out: List[Hashable] = []
        for key in self._order:
            if len(out) >= k:
                break
            if key not in pinned:
                out.append(key)
        return out


class Clock(EvictionPolicy):
    """Second-chance CLOCK — cheaper bookkeeping than strict LRU; what an
    actual firmware/kernel implementation would use."""

    def __init__(self) -> None:
        self._ref: Dict[Hashable, bool] = {}
        self._ring: List[Hashable] = []
        self._hand = 0

    def on_insert(self, key: Hashable) -> None:
        if key not in self._ref:
            self._ring.append(key)
        self._ref[key] = True

    def on_access(self, key: Hashable) -> None:
        if key in self._ref:
            self._ref[key] = True

    def on_remove(self, key: Hashable) -> None:
        if key in self._ref:
            del self._ref[key]
            idx = self._ring.index(key)
            self._ring.pop(idx)
            if idx < self._hand:
                self._hand -= 1
            if self._ring:
                self._hand %= len(self._ring)
            else:
                self._hand = 0

    def victim(self) -> Optional[Hashable]:
        if not self._ring:
            return None
        scanned = 0
        # two sweeps max: first clears ref bits, second must find a victim
        while scanned < 2 * len(self._ring):
            key = self._ring[self._hand]
            self._hand = (self._hand + 1) % len(self._ring)
            scanned += 1
            if key in self._pinned():
                continue
            if self._ref.get(key, False):
                self._ref[key] = False
            else:
                return key
        # everything pinned or referenced: pick first unpinned
        for key in self._ring:
            if key not in self._pinned():
                return key
        return None


class CostAwareLRU(LRU):
    """LRU weighted by refetch cost: pages that are cheap to refetch (clean,
    small) are preferred victims over dirty pages that must be written back
    first.  TPU adaptation detail: a dirty page costs a D2H *and* a later H2D.
    """

    def __init__(self) -> None:
        super().__init__()
        self._dirty: set = set()

    def mark_dirty(self, key: Hashable, dirty: bool = True) -> None:
        (self._dirty.add if dirty else self._dirty.discard)(key)

    def on_remove(self, key: Hashable) -> None:
        super().on_remove(key)
        self._dirty.discard(key)

    def victim(self) -> Optional[Hashable]:
        # prefer the least-recent CLEAN page; fall back to LRU order
        for key in self._order:
            if key in self._pinned():
                continue
            if key not in self._dirty:
                return key
        return super().victim()

    def victims(self, k: int) -> List[Hashable]:
        # clean pages in LRU order first, then dirty — the order k
        # successive victim() rounds would produce
        pinned = self._pinned()
        clean: List[Hashable] = []
        dirty: List[Hashable] = []
        for key in self._order:
            if key in pinned:
                continue
            (dirty if key in self._dirty else clean).append(key)
        return (clean + dirty)[:k]


def make_policy(name: str) -> EvictionPolicy:
    return {"lru": LRU, "clock": Clock, "cost": CostAwareLRU}[name]()


@dataclasses.dataclass(frozen=True)
class PrefetchRun:
    """One chunk-aligned run of pages to move as a single coalesced
    burst.  ``source`` records how the run was predicted: ``scheduled``
    (exact future knowledge from a scheduler) outranks ``stride``
    (heuristic extrapolation) at admission time."""

    pages: Tuple[int, ...]
    source: str                  # "scheduled" | "stride"

    @property
    def npages(self) -> int:
        return len(self.pages)


class Prefetcher:
    """Burst-native sequential/stride prefetcher over page indices.

    ``observe`` consumes the access stream (stride detection: confidence
    builds on repeated strides, resets on a change, fires at >= 2,
    saturates at 4 — pinned by a regression test); ``schedule`` takes
    exact future knowledge from a scheduler, which always takes priority
    over stride guesses.

    The consumer-facing surface is :meth:`suggest_runs`: up to ``depth``
    pages per round, emitted as chunk-aligned :class:`PrefetchRun`\\ s so
    every prefetch burst rides the coalesced data path (one transfer +
    one link charge per run) instead of page-at-a-time moves.  The
    legacy :meth:`suggest` flat view remains for callers that predate
    the run API.

    Backlog discipline (the scheduled queue is a deque, not an
    unbounded list):

      * capped at ``backlog_factor * depth`` pages — overflow drops the
        OLDEST hints (they are the ones demand is about to overtake);
      * a scheduled page that gets demand-faulted first is dropped
        lazily (``observe`` marks it stale; the pop skips it) instead
        of being prefetched after the fact;
      * runs the overlap scheduler could not fit behind compute are
        ``defer``-ed back to the FRONT of the queue, preserving order —
        deferred exact knowledge is re-issued next round, never lost.
    """

    def __init__(self, depth: int = 4, backlog_factor: int = 8):
        self.depth = depth
        self.backlog = max(int(backlog_factor) * max(depth, 1), 1)
        self._last: Optional[int] = None
        self._stride: Optional[int] = None
        self._confidence = 0
        self._scheduled: deque[int] = deque()
        self._backlogged: set = set()    # members of _scheduled
        self._stale: set = set()         # demand-faulted before issue
        self.dropped_overflow = 0
        self.dropped_stale = 0

    # ---------------------------------------------------------- scheduling
    def schedule(self, pages: Sequence[int]) -> None:
        """Exact future knowledge from the scheduler (takes priority).
        Duplicates already backlogged are ignored; overflow beyond the
        backlog cap sheds the OLDEST entries."""
        for p in pages:
            if p in self._backlogged:
                self._stale.discard(p)   # re-scheduled: live again
                continue
            self._scheduled.append(p)
            self._backlogged.add(p)
        while len(self._scheduled) > self.backlog:
            old = self._scheduled.popleft()
            self._backlogged.discard(old)
            self._stale.discard(old)
            self.dropped_overflow += 1

    def defer(self, pages: Sequence[int]) -> None:
        """Re-queue pages an admission decision could not issue this
        round, at the FRONT (they keep their priority next round)."""
        fresh = [p for p in pages if p not in self._backlogged]
        self._scheduled.extendleft(reversed(fresh))
        self._backlogged.update(fresh)

    def pending(self) -> int:
        """Backlogged scheduled pages still waiting to be issued."""
        return len(self._scheduled)

    # ------------------------------------------------------------- stream
    def observe(self, page: int) -> None:
        """Consume one access.  Also invalidates a backlogged hint for
        this page: demand beat the prefetch, so issuing it later would
        move bytes nobody is waiting for."""
        if page in self._backlogged:
            self._stale.add(page)
        if self._last is not None:
            stride = page - self._last
            if stride != 0:
                if stride == self._stride:
                    self._confidence = min(self._confidence + 1, 4)
                else:
                    self._stride = stride
                    self._confidence = 1
        self._last = page

    # ---------------------------------------------------------- suggestion
    def _pop_scheduled(self, max_page: int, budget: int) -> List[int]:
        """Up to ``budget`` live scheduled pages, FIFO, stale-skipped."""
        out: List[int] = []
        while self._scheduled and len(out) < budget:
            p = self._scheduled.popleft()
            self._backlogged.discard(p)
            if p in self._stale:
                self._stale.discard(p)
                self.dropped_stale += 1
                continue
            if 0 <= p <= max_page and p not in out:
                out.append(p)
        return out

    def _stride_guesses(self, max_page: int, budget: int) -> List[int]:
        if budget <= 0 or self._confidence < 2 or not self._stride \
                or self._last is None:
            return []
        out: List[int] = []
        nxt = self._last
        for _ in range(budget):
            nxt += self._stride
            if 0 <= nxt <= max_page:
                out.append(nxt)
        return out

    @staticmethod
    def _group_runs(pages: Sequence[int], run_pages: int,
                    source: str) -> List[PrefetchRun]:
        """Group pages into chunk-aligned runs (same ``page // run_pages``
        extent), preserving first-seen order of the extents."""
        runs: "OrderedDict[int, List[int]]" = OrderedDict()
        for p in pages:
            runs.setdefault(p // run_pages, []).append(p)
        return [PrefetchRun(tuple(ps), source) for ps in runs.values()]

    def suggest_runs(self, max_page: int,
                     run_pages: int = 1) -> List[PrefetchRun]:
        """Up to ``depth`` predicted pages as chunk-aligned runs.

        Scheduled pages are consumed first (and grouped per ``run_pages``
        extent — the LinkedBuffer passes its LMB chunk size so each run
        maps to one (chunk, expander) burst); any remaining budget is
        filled by promoting the stride detector to a run extent: the
        next ``depth`` strides ahead of the last access, grouped the
        same way.
        """
        run_pages = max(run_pages, 1)
        taken = self._pop_scheduled(max_page, self.depth)
        runs = self._group_runs(taken, run_pages, "scheduled")
        guesses = [g for g in
                   self._stride_guesses(max_page, self.depth - len(taken))
                   if g not in taken]
        runs.extend(self._group_runs(guesses, run_pages, "stride"))
        return runs

    def suggest(self, max_page: int) -> List[int]:
        """Legacy flat view of :meth:`suggest_runs` (single-page grain)."""
        return [p for run in self.suggest_runs(max_page)
                for p in run.pages]
