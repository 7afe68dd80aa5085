"""Overlap scheduling: how much prefetch traffic hides behind compute.

The paper's sequential fio results are the friendly case for LMB because
the CXL round-trip can ride *under* ongoing work — the link keeps enough
outstanding transfers in flight that by the time the device touches the
next pages, their bytes already arrived (latency hiding via outstanding
transfers, the standard CXL-interconnect argument; pool papers make the
same case for scheduled bulk moves amortizing pool bandwidth).

This module is the decision point between the burst-native
:class:`~repro_torch.core.policy.Prefetcher` (which proposes chunk-aligned
runs) and the :class:`~repro_torch.core.buffer.LinkedBuffer` data path (which
moves them):

  * :func:`exposed_latency_s` / :func:`hidden_fraction` — the pure cost
    math, shared with the discrete-event simulator (``repro_torch.sim.engine``
    models a prefetching device's external L2P access as hidden up to
    its lookahead window).
  * :class:`OverlapScheduler` — per-buffer runtime state: tracks the
    current compute window (either declared per step or EWMA-learned
    from observed step times), converts it to a byte budget with
    :func:`repro_torch.core.tiers.hideable_page_bytes`, and admits whole runs
    in priority order until the budget is spent.  Runs that do not fit
    are DEFERRED (handed back to the prefetcher's backlog), never
    dropped: exact scheduled knowledge stays exact.

Admission is order-preserving: runs arrive scheduled-first (exact future
knowledge) then stride guesses, and admission stops at the first run
that does not fit — a later, smaller run must not jump a deferred
scheduled run, or the "scheduled pages take priority" invariant breaks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.tiers import TierSpec, hideable_page_bytes
from repro_torch.obs.trace import GLOBAL_TRACER, SpanTracer


def exposed_latency_s(added_latency_s: float,
                      compute_window_s: float) -> float:
    """Latency still visible after hiding behind a compute window.

    A prefetched access issued ``compute_window_s`` ahead of its use
    exposes only the part of the tier latency the window could not
    cover.  Never negative; window <= 0 exposes everything (the
    demand-paging case).
    """
    return max(added_latency_s - max(compute_window_s, 0.0), 0.0)


def hidden_fraction(added_latency_s: float,
                    compute_window_s: float) -> float:
    """Fraction of the tier latency a compute window hides (0..1)."""
    if added_latency_s <= 0:
        return 1.0
    exposed = exposed_latency_s(added_latency_s, compute_window_s)
    return 1.0 - exposed / added_latency_s


@dataclasses.dataclass
class OverlapStats:
    """Running totals one OverlapScheduler accumulates."""

    admitted_runs: int = 0
    deferred_runs: int = 0
    admitted_pages: int = 0
    deferred_pages: int = 0
    hidden_bytes: int = 0


class OverlapScheduler:
    """Decides how many prefetch runs fit behind the compute window.

    ``tier`` is the cost model of the link the prefetch traffic rides
    (bandwidth + added latency); ``streams`` models multiple DMA
    engines.  The compute window can be driven two ways, composable:

      * ``start_window(seconds)`` — the consumer declares the next
        step's compute time up front (simulators, benchmarks);
      * ``observe_compute(seconds)`` — EWMA over measured step times
        (the serving engine feeds its decode-round wall time), then
        ``start_window()`` with no argument opens the next window at
        the learned estimate.

    Each window has a byte budget
    (:func:`~repro_torch.core.tiers.hideable_page_bytes`); :meth:`admit`
    spends it on whole runs in arrival order and defers the rest.
    """

    def __init__(self, tier: TierSpec, *,
                 compute_window_s: float = 0.0,
                 streams: int = 1,
                 ewma_alpha: float = 0.3,
                 trace: Optional[SpanTracer] = None):
        self.tier = tier
        self.streams = max(int(streams), 1)
        self._window_s = max(compute_window_s, 0.0)
        self._alpha = ewma_alpha
        self._spent_bytes = 0
        self.stats = OverlapStats()
        self.trace = trace if trace is not None else GLOBAL_TRACER

    # ------------------------------------------------------------- window
    @property
    def window_s(self) -> float:
        """Current compute-window estimate (seconds)."""
        return self._window_s

    def observe_compute(self, seconds: float) -> None:
        """Fold one measured compute-step duration into the estimate."""
        seconds = max(seconds, 0.0)
        if self._window_s <= 0.0:
            self._window_s = seconds
        else:
            self._window_s += self._alpha * (seconds - self._window_s)

    def start_window(self, compute_window_s: Optional[float] = None) -> None:
        """Open a new compute window: reset the spent-budget counter and
        (optionally) pin the window length for this step."""
        if compute_window_s is not None:
            self._window_s = max(compute_window_s, 0.0)
        self._spent_bytes = 0

    # ------------------------------------------------------------- budget
    def budget_bytes(self) -> int:
        """Total bytes hideable behind the current window."""
        return hideable_page_bytes(self._window_s, self.tier, self.streams)

    def remaining_bytes(self) -> int:
        return max(self.budget_bytes() - self._spent_bytes, 0)

    def admit(self, run_sizes: Sequence[int],
              page_bytes: int) -> Tuple[int, List[int]]:
        """Admit whole runs, in order, while they fit the window budget.

        ``run_sizes`` is the page count of each candidate run (priority
        order: scheduled first).  Returns ``(n_admitted, sizes)`` — the
        number of leading runs admitted and, for convenience, the
        per-run sizes actually charged.  Admission stops at the first
        run that does not fit; everything after it is counted deferred
        (the caller re-queues those pages, it does not drop them).
        """
        admitted = 0
        charged: List[int] = []
        for size in run_sizes:
            nbytes = size * page_bytes
            if nbytes > self.remaining_bytes():
                break
            self._spent_bytes += nbytes
            self.stats.admitted_runs += 1
            self.stats.admitted_pages += size
            self.stats.hidden_bytes += nbytes
            charged.append(size)
            admitted += 1
        for size in run_sizes[admitted:]:
            self.stats.deferred_runs += 1
            self.stats.deferred_pages += size
        tr = self.trace
        if tr.enabled and run_sizes:
            tr.event("overlap.admit", op="prefetch",
                     nbytes=sum(charged) * page_bytes,
                     runs=admitted, pages=sum(charged),
                     deferred_runs=len(run_sizes) - admitted,
                     window_s=self._window_s)
        return admitted, charged

    def snapshot(self) -> dict:
        return {
            "window_s": self._window_s,
            "budget_bytes": self.budget_bytes(),
            "remaining_bytes": self.remaining_bytes(),
            "streams": self.streams,
            **dataclasses.asdict(self.stats),
        }
