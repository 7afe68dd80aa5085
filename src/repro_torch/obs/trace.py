"""Bounded ring-buffer span tracer for the LMB data path.

Design constraints, in order:

1. **Near-zero disabled path.**  Tracing is off by default; every
   instrumented call site guards with ``if tracer.enabled:`` (one
   attribute load + branch) before touching anything else, and the
   ``span(...)`` context manager returns a shared no-op object when
   disabled.  The hot paths (scalar fault, per-page meter) pay nothing
   measurable.
2. **Bounded memory.**  Spans land in a preallocated ring; once
   ``capacity`` is reached the oldest spans are overwritten and
   ``dropped`` counts them, so a tracer left on for a long sweep can
   never grow without bound (the same cap bounds ``Metrics._events``).
3. **Attributable.**  Every span carries tenant, expander, op class
   (demand / prefetch / migrate / ...), byte count, and a parent span
   id (maintained by a per-tracer stack of open spans) so exporters can
   reconstruct the fault → burst → link-charge hierarchy and group
   tracks per expander link and per tenant.

Clocks: ``t0`` is wall time (``time.monotonic``) relative to the
tracer's epoch.  ``dur`` is *whatever the emitter says it is* — wall
seconds for compute-side spans, **modeled virtual seconds** for link
transfer spans (the arbiter's ``TransferGrant.delay_s``), which is what
makes span sums reconcile exactly with the fabric byte/wait counters.
Exporters record which convention a span used via its name/args.

The port adds what puts its spans on a profiler's timeline:

* every span opened with :meth:`SpanTracer.span` is also a
  ``torch.profiler.record_function`` range of the same name, entered only
  while tracing is on and a profiler records, so a ``torch.profiler``
  trace holds each one on the profiler's clock beside the card's
  kernels; a span recorded with
  :meth:`SpanTracer.add` never is one, and one whose ``dur`` is modeled
  says so: ``args["clock"] == "modeled"`` (``link.xfer``,
  ``fault.transient``), which the Chrome exporter puts on a track of its
  own;
* :attr:`SpanTracer.epoch`, the ``time.monotonic`` instant every ``t0``
  counts from, so a reader puts spans on the host clock;
* fields filled in after a span closed (:meth:`SpanTracer.defer`): a
  burst's link seconds, read from its copy stream's events once they have
  passed, without a host sync on the path that recorded it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from collections.abc import Callable
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import torch

#: shared cap for the span ring and for ``Metrics._events``
DEFAULT_RING_CAPACITY = 65536


@dataclass
class Span:
    """One structured trace record (a closed interval or an instant)."""

    name: str                       # e.g. "link.xfer", "fault.batch"
    t0: float                       # seconds since tracer epoch
    dur: float                      # seconds (0.0 for instant events)
    op: str = ""                    # traffic class: demand/prefetch/...
    tenant: Optional[str] = None
    expander: Optional[int] = None
    nbytes: int = 0
    span_id: int = 0
    parent_id: Optional[int] = None
    args: Dict[str, Any] = field(default_factory=dict)


class _NullSpan:
    """Singleton no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: object) -> bool:
        return False


_NULL_SPAN = _NullSpan()
#: the no-op a call site opens when tracing is off, so that its guard is
#: one attribute check: ``with tr.span(...) if tr.enabled else NULL_SPAN:``
NULL_SPAN = _NULL_SPAN


class SpanTracer:
    """Thread-safe bounded span recorder.

    ``enabled`` may be flipped at any time; call sites re-check it per
    operation.  All mutation happens under one lock — contention is a
    non-issue at the span rates the model produces, and correctness
    under the serve engine's future threading is free.
    """

    def __init__(self, capacity: int = DEFAULT_RING_CAPACITY,
                 enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._buf: List[Optional[Span]] = [None] * self.capacity
        self._head = 0              # next write slot
        self._count = 0             # live spans (<= capacity)
        self.dropped = 0            # spans overwritten after wrap
        self._next_id = 1
        self._stack: List[int] = []  # open span ids (for parenting)
        self._epoch = time.monotonic()
        #: the span :meth:`add` recorded last (:meth:`closed`)
        self.last: Optional[Span] = None
        #: resolvers of fields filled in later (:meth:`defer`), oldest first
        self._deferred: deque = deque()

    # -- clock -----------------------------------------------------
    def now(self) -> float:
        """Wall seconds since this tracer's epoch."""
        return time.monotonic() - self._epoch

    @property
    def epoch(self) -> float:
        """The ``time.monotonic`` instant ``t0`` counts from: a span
        began at ``epoch + t0`` on the host clock."""
        return self._epoch

    # -- recording -------------------------------------------------
    def add(self, name: str, t0: float, dur: float, *, op: str = "",
            tenant: Optional[str] = None, expander: Optional[int] = None,
            nbytes: int = 0, parent_id: Optional[int] = None,
            span_id: Optional[int] = None, **args: Any) -> int:
        """Record a closed span; returns its id.  No-op when disabled."""
        if not self.enabled:
            return 0
        with self._lock:
            if span_id is None:
                span_id = self._next_id
                self._next_id += 1
            if parent_id is None and self._stack:
                parent_id = self._stack[-1]
            s = Span(name=name, t0=t0, dur=dur, op=op, tenant=tenant,
                     expander=expander, nbytes=nbytes, span_id=span_id,
                     parent_id=parent_id, args=args)
            if self._buf[self._head] is not None:
                self.dropped += 1
            else:
                self._count += 1
            self._buf[self._head] = s
            self.last = s
            self._head = (self._head + 1) % self.capacity
            return span_id

    def event(self, name: str, **kw: Any) -> int:
        """Record an instant (zero-duration) event at ``now()``."""
        if not self.enabled:
            return 0
        return self.add(name, self.now(), 0.0, **kw)

    @contextmanager
    def _span_cm(self, name: str, kw: Dict[str, Any]) -> Iterator[int]:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            parent = self._stack[-1] if self._stack else None
            self._stack.append(sid)
        # the same range on the profiler's clock while a profiler records
        # (entering one costs about twice the span's own bookkeeping)
        rng = (torch.profiler.record_function(name)
               if torch._C._autograd._profiler_enabled() else None)
        if rng is not None:
            rng.__enter__()
        t0 = self.now()
        try:
            yield sid
        finally:
            dur = self.now() - t0
            if rng is not None:
                rng.__exit__(None, None, None)
            with self._lock:
                if self._stack and self._stack[-1] == sid:
                    self._stack.pop()
                elif sid in self._stack:    # unbalanced exit
                    self._stack.remove(sid)
            self.add(name, t0, dur, parent_id=parent, span_id=sid, **kw)

    def span(self, name: str, **kw: Any):
        """Context manager recording a wall-clock span around a block.

        Children recorded while the block is open (via nested ``span``
        or plain ``add``/``event``) get this span as their parent.
        When disabled, returns a shared no-op — no allocation.
        """
        if not self.enabled:
            return _NULL_SPAN
        return self._span_cm(name, kw)

    def closed(self, span_id: int) -> Optional[Span]:
        """Span ``span_id`` if it is the one recorded last (a ``span``
        block that just closed), for its caller to add to its ``args``
        what it learned inside the block; else None."""
        s = self.last
        return s if s is not None and s.span_id == span_id else None

    def defer(self, resolve: Callable[[bool], bool]) -> None:
        """Fill fields of a recorded span later.  ``resolve(wait)`` sets
        them in the span's ``args`` and returns True; with ``wait`` False
        it may instead return False when they cannot be read yet (a copy
        still on its stream), and is tried again later.  The pending are
        tried, oldest first and without waiting, at every ``defer``, and
        all run to the end by ``resolve_deferred(wait=True)`` and by
        :meth:`spans`.  Past ``capacity`` pending, the oldest is dropped
        and its span keeps its fields unset.  No-op when disabled."""
        if not self.enabled:
            return
        self._deferred.append(resolve)
        self.resolve_deferred(wait=False)
        while len(self._deferred) > self.capacity:
            self._deferred.popleft()

    def resolve_deferred(self, wait: bool = True) -> None:
        """Run the pending resolvers (:meth:`defer`) oldest first; without
        ``wait``, stop at the first that cannot be resolved yet."""
        while self._deferred:
            if not self._deferred[0](wait):
                return
            self._deferred.popleft()

    # -- reading ---------------------------------------------------
    def spans(self) -> List[Span]:
        """Live spans, oldest first (post-wrap order preserved)."""
        self.resolve_deferred(wait=True)
        with self._lock:
            if self._count < self.capacity:
                out = [s for s in self._buf[:self._count]]
            else:
                out = self._buf[self._head:] + self._buf[:self._head]
            return [s for s in out if s is not None]

    def __len__(self) -> int:
        return self._count

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._head = 0
            self._count = 0
            self.dropped = 0
            self._stack.clear()
            self._epoch = time.monotonic()
            self.last = None
            self._deferred.clear()

    def snapshot(self) -> Dict[str, Any]:
        return {"enabled": self.enabled, "capacity": self.capacity,
                "count": self._count, "dropped": self.dropped}


#: process-wide default tracer — disabled; every component that is not
#: handed an explicit tracer falls back to this one, so flipping it on
#: (``enable_tracing``) instruments systems built afterwards *and*
#: already-running ones with zero plumbing.
GLOBAL_TRACER = SpanTracer(capacity=DEFAULT_RING_CAPACITY, enabled=False)


def enable_tracing(capacity: Optional[int] = None) -> SpanTracer:
    """Turn on the process-wide tracer (optionally resizing) and
    return it.  Clears previously recorded spans."""
    if capacity is not None and capacity != GLOBAL_TRACER.capacity:
        GLOBAL_TRACER.capacity = int(capacity)
    GLOBAL_TRACER.clear()
    GLOBAL_TRACER.enabled = True
    return GLOBAL_TRACER


def disable_tracing() -> None:
    """Turn the process-wide tracer back off (spans are kept)."""
    GLOBAL_TRACER.enabled = False
