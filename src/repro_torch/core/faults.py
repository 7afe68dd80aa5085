"""Transient-fault chaos layer for the CXL fabric.

Real CXL fabrics fail *transiently* long before they fail-stop: CRC
errors trigger link-level retry, links retrain (flap) after signal
loss, switches brown out under congestion or thermal pressure, and the
RAS machinery contains poison instead of killing the host.  The repo's
fail-stop path (``FabricManager.inject_failure`` → failover → degraded
mode) models only the terminal case; this module supplies everything
before it, plus the piece fail-stop never had — **repair**:

  * :class:`FaultEvent` / :class:`FaultPlan` — a declarative, timed
    script of faults (transient CRC-error windows, latency brownouts,
    link flaps with retrain delay, fail-stop, repair/re-admission),
    targeted at one expander, a topology failure domain, or the pool.
  * :class:`RetryPolicy` — bounded exponential backoff with seeded
    jitter and a per-link retry budget; transient errors cost modeled
    time (backoff + CRC-retry + retransmission wire time) and escalate
    to the existing failover path ONLY when the budget is exhausted.
  * :class:`FaultInjector` — attaches to a ``FabricManager``
    (:meth:`FabricManager.attach_fault_injector`), advances with the
    fabric's virtual link time, fires due events, and perturbs every
    ``meter_transfer`` according to the active fault state.

The graceful-degradation ladder this implements:

    healthy → brownout-aware placement/migration avoidance (the FM's
    placement views see a saturated link for browned-out expanders)
    → failover (budget-exhausted escalation or scripted fail-stop)
    → onboard-only degraded (``LinkedBuffer.degraded``)
    → repaired (``FabricManager.readmit_expander`` un-fails the
    expander blank and consumers exit degraded mode)

Determinism contract (the chaos_sweep CI gate pins it): a zero-fault
plan draws NO randomness and perturbs NO transfer — a run with an
attached zero-fault injector is byte-identical (tokens and per-class
``fm.op_bytes()``) to a run with no injector at all.  All randomness
is derived per-transfer from ``SeedSequence([seed, transfer_index])``,
so for a fixed seed the error draw of transfer *i* is independent of
how many retries earlier transfers performed — which also makes total
modeled retry time monotone in the error rate (the property suite
pins that too).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.pool import LMBError

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.fabric import FabricManager

#: event kinds a FaultPlan may script
FAULT_KINDS = ("transient", "brownout", "link_flap", "fail_stop", "repair")

#: placement-view utilization reported for a browned-out expander —
#: saturated, so least-loaded/pool-aware policies (and the migration
#: engine's target query, which delegates to them) steer around it
BROWNOUT_VIEW_UTILIZATION = 1.0


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault, fired when injector time reaches ``t_s``.

    Targeting: ``expander_id`` names one expander; ``domain`` names a
    topology failure domain (every pooled expander in it); neither
    means every pooled expander.  Windowed kinds (transient, brownout)
    stay active for ``duration_s`` after firing; ``link_flap`` holds
    the link in retrain for ``retrain_s``; ``fail_stop`` and
    ``repair`` are instantaneous state changes.
    """

    t_s: float
    kind: str
    expander_id: Optional[int] = None
    domain: Optional[str] = None
    #: window length for "transient"/"brownout"
    duration_s: float = 0.0
    #: "transient": per-transfer CRC-error probability inside the window
    error_rate: float = 0.0
    #: "transient": modeled cost of one CRC retry round (link-level
    #: ack/replay latency), on top of backoff + retransmission wire time
    crc_retry_cost_s: float = 1e-6
    #: "brownout": multiplier on the modeled link delay inside the window
    latency_factor: float = 1.0
    #: "link_flap": retrain time the link is unusable for
    retrain_s: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (one of {FAULT_KINDS})")
        if self.t_s < 0:
            raise ValueError("fault event time must be >= 0")
        if self.expander_id is not None and self.domain is not None:
            raise ValueError("target either an expander or a domain")
        if self.kind == "transient" and not 0.0 <= self.error_rate <= 1.0:
            raise ValueError("error_rate must be in [0, 1]")
        if self.kind == "brownout" and self.latency_factor < 1.0:
            raise ValueError("brownout latency_factor must be >= 1")
        if self.duration_s < 0 or self.retrain_s < 0:
            raise ValueError("durations must be >= 0")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A declarative fault script: timed events, executed in order.

    An empty plan is the determinism baseline — attaching an injector
    with it changes nothing observable.  Convenience constructors
    build the common storm shapes used by tests and chaos_sweep.
    """

    events: Tuple[FaultEvent, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events, key=lambda e: e.t_s)))

    def __len__(self) -> int:
        return len(self.events)

    @staticmethod
    def storm(*, t0_s: float, duration_s: float, error_rate: float,
              expander_id: Optional[int] = None,
              crc_retry_cost_s: float = 1e-6) -> "FaultPlan":
        """A single transient-error window (the canonical CRC storm)."""
        return FaultPlan((FaultEvent(
            t0_s, "transient", expander_id=expander_id,
            duration_s=duration_s, error_rate=error_rate,
            crc_retry_cost_s=crc_retry_cost_s),))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff for transient link errors.

    Per-transfer: up to ``max_retries`` attempts, each costing
    ``backoff_s(attempt)`` (seeded jitter) + the event's CRC-retry cost
    + the retransmission's wire time (re-metered through the link
    arbiter, so retries contend like real traffic).  Per-link: a
    ``link_retry_budget`` shared across transfers — once spent, the
    next transient error escalates to the failover path instead of
    retrying (the link is declared dead at the next fabric heartbeat).
    ``max_retries=0`` disables retries outright: the first transient
    error escalates.
    """

    max_retries: int = 4
    backoff_base_s: float = 2e-6
    backoff_multiplier: float = 2.0
    backoff_max_s: float = 1e-3
    #: symmetric jitter fraction applied to each backoff (seeded draw)
    jitter: float = 0.1
    #: total retries one link may spend before escalation; None = unbounded
    link_retry_budget: Optional[int] = 256

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("backoff times must be >= 0")
        if self.backoff_multiplier < 1.0:
            raise ValueError("backoff_multiplier must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        if (self.link_retry_budget is not None
                and self.link_retry_budget < 0):
            raise ValueError("link_retry_budget must be >= 0 or None")

    def backoff_s(self, attempt: int, u: float) -> float:
        """Backoff before retry ``attempt`` (0-based); ``u`` in [0, 1)
        supplies the jitter draw."""
        base = min(self.backoff_base_s * self.backoff_multiplier ** attempt,
                   self.backoff_max_s)
        return base * (1.0 + self.jitter * (2.0 * u - 1.0))


@dataclasses.dataclass
class _LinkFaultState:
    """Mutable per-expander fault state (windows expire passively)."""

    error_rate: float = 0.0
    error_until: float = 0.0
    crc_retry_cost_s: float = 0.0
    brownout_factor: float = 1.0
    brownout_until: float = 0.0
    retrain_until: float = 0.0
    budget_left: Optional[int] = None
    escalated: bool = False
    # counters
    transient_errors: int = 0
    retries: int = 0
    retry_bytes: int = 0
    retry_delay_s: float = 0.0
    brownout_delay_s: float = 0.0
    flap_delay_s: float = 0.0
    escalations: int = 0


class FaultInjector:
    """Executes a :class:`FaultPlan` against one ``FabricManager``.

    Attach with :meth:`FabricManager.attach_fault_injector`; the FM
    advances injector time from ``advance_links`` (the same virtual
    clock the link arbiters drain on) and consults
    :meth:`on_transfer` from ``meter_transfer``.  Scripted fail-stop /
    repair events call the FM's own ``inject_failure`` /
    ``readmit_expander``; budget-exhausted escalations are deferred to
    the next :meth:`advance` tick (the management-plane heartbeat), so
    a failover never fires mid-burst under a consumer's feet.
    """

    def __init__(self, plan: FaultPlan,
                 retry: RetryPolicy = RetryPolicy(),
                 seed: int = 0):
        self.plan = plan
        self.retry = retry
        self.seed = int(seed)
        self.now_s = 0.0
        self._events: List[FaultEvent] = list(plan.events)
        self._next_event = 0
        self._fm: Optional["FabricManager"] = None
        self._links: Dict[int, _LinkFaultState] = {}
        self._pending_escalation: List[int] = []
        self._xfer_count = 0

    # --------------------------------------------------------------- wiring
    def bind(self, fm: "FabricManager") -> None:
        if self._fm is not None and self._fm is not fm:
            raise LMBError("FaultInjector is already bound to a fabric")
        self._fm = fm

    def _state(self, expander_id: int) -> _LinkFaultState:
        st = self._links.get(expander_id)
        if st is None:
            st = _LinkFaultState(budget_left=self.retry.link_retry_budget)
            self._links[expander_id] = st
        return st

    def _targets(self, ev: FaultEvent) -> List[int]:
        fm = self._fm
        if ev.expander_id is not None:
            return [ev.expander_id]
        if ev.domain is not None:
            if fm.topology is None:
                raise LMBError(
                    f"fault event targets domain {ev.domain!r} but the "
                    "fabric has no topology")
            return [e for e in fm.topology.expanders_in_domain(ev.domain)
                    if e in fm.expander_ids]
        return list(fm.expander_ids)

    # ----------------------------------------------------------- time/plan
    def advance(self, dt_s: float) -> None:
        """Advance injector time with the fabric's link clock; fire due
        events and apply deferred escalations."""
        self.now_s += dt_s
        while (self._next_event < len(self._events)
               and self._events[self._next_event].t_s <= self.now_s):
            self._fire(self._events[self._next_event])
            self._next_event += 1
        if self._pending_escalation:
            pend, self._pending_escalation = self._pending_escalation, []
            for eid in pend:
                # idempotent: inject_failure no-ops (with a journal
                # entry) if a scripted fail_stop beat the escalation
                self._fm.inject_failure(eid)

    def _fire(self, ev: FaultEvent) -> None:
        tr = self._fm.tracer
        for eid in self._targets(ev):
            st = self._state(eid)
            if ev.kind == "transient":
                st.error_rate = ev.error_rate
                st.error_until = self.now_s + ev.duration_s
                st.crc_retry_cost_s = ev.crc_retry_cost_s
            elif ev.kind == "brownout":
                st.brownout_factor = ev.latency_factor
                st.brownout_until = self.now_s + ev.duration_s
            elif ev.kind == "link_flap":
                st.retrain_until = self.now_s + ev.retrain_s
            elif ev.kind == "fail_stop":
                self._fm.inject_failure(eid)
            elif ev.kind == "repair":
                self._fm.readmit_expander(eid)
                # repaired link comes back clean: windows closed, budget
                # refilled, escalation latch released
                self._links[eid] = _LinkFaultState(
                    budget_left=self.retry.link_retry_budget)
            if tr.enabled:
                tr.event(f"fault.{ev.kind}", op="fault", expander=eid,
                         t_s=ev.t_s, duration_s=ev.duration_s,
                         error_rate=ev.error_rate,
                         latency_factor=ev.latency_factor,
                         retrain_s=ev.retrain_s)

    # ------------------------------------------------------------ data path
    def _xfer_rng(self) -> np.random.Generator:
        """A per-transfer seeded substream: transfer *i*'s draws do not
        depend on how many draws earlier transfers consumed.  This is
        what makes retry time monotone in error rate (coupled uniforms)
        and keeps the zero-fault path RNG-free."""
        self._xfer_count += 1
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self._xfer_count]))

    def on_transfer(self, device_id: str, expander_id: int, nbytes: int,
                    op: str, base_delay_s: float,
                    charge) -> Tuple[float, int]:
        """Perturb one metered transfer on ``expander_id``.

        Returns ``(extra_delay_s, retry_bytes)``: modeled time added on
        top of the base grant, and bytes retransmitted (the FM accrues
        them under the ``"retry"`` op class).  ``charge(nbytes)`` meters
        a retransmission through the link arbiter and returns its wire
        delay.  The no-active-fault path touches no RNG and returns
        ``(0.0, 0)``.
        """
        st = self._links.get(expander_id)
        if st is None:
            return 0.0, 0
        now = self.now_s
        extra = 0.0
        retry_bytes = 0
        if now < st.retrain_until:
            # link is retraining: the transfer queues until it is back up
            d = st.retrain_until - now
            st.flap_delay_s += d
            extra += d
        if now < st.brownout_until and st.brownout_factor > 1.0:
            d = base_delay_s * (st.brownout_factor - 1.0)
            st.brownout_delay_s += d
            extra += d
        if now < st.error_until and st.error_rate > 0.0:
            rng = self._xfer_rng()
            if float(rng.random()) < st.error_rate:
                d, retry_bytes = self._transient(
                    st, expander_id, device_id, nbytes, op, rng, charge)
                extra += d
        return extra, retry_bytes

    def _transient(self, st: _LinkFaultState, expander_id: int,
                   device_id: str, nbytes: int, op: str,
                   rng: np.random.Generator,
                   charge) -> Tuple[float, int]:
        """One transfer hit a CRC error: retry per policy, escalate on
        budget exhaustion.  Returns (extra_delay_s, retried_bytes)."""
        pol = self.retry
        st.transient_errors += 1
        extra = 0.0
        retry_bytes = 0
        recovered = False
        for attempt in range(pol.max_retries):
            if st.budget_left is not None and st.budget_left <= 0:
                break
            if st.budget_left is not None:
                st.budget_left -= 1
            st.retries += 1
            d = (pol.backoff_s(attempt, float(rng.random()))
                 + st.crc_retry_cost_s + charge(nbytes))
            st.retry_delay_s += d
            extra += d
            retry_bytes += nbytes
            st.retry_bytes += nbytes
            if float(rng.random()) >= st.error_rate:
                recovered = True
                break
        if not recovered:
            # link-level retry keeps the transfer alive while budget
            # remains (the cost is modeled above); escalation to the
            # fail-stop/failover path happens only once the link's retry
            # budget is spent — or immediately when retries are disabled
            budget_spent = (st.budget_left is not None
                            and st.budget_left <= 0)
            if pol.max_retries == 0 or budget_spent:
                self._escalate(st, expander_id)
        tr = self._fm.tracer
        if tr.enabled:
            tr.add("fault.transient", tr.now(), extra, op=op,
                   expander=expander_id, nbytes=nbytes, device=device_id,
                   clock="modeled",
                   retries=st.retries, recovered=recovered)
        return extra, retry_bytes

    def _escalate(self, st: _LinkFaultState, expander_id: int) -> None:
        """Retry budget exhausted (or retries disabled): hand the link
        to the failover path at the next management heartbeat."""
        if st.escalated:
            return
        st.escalated = True
        st.escalations += 1
        self._pending_escalation.append(expander_id)
        tr = self._fm.tracer
        if tr.enabled:
            tr.event("fault.escalate", op="fault", expander=expander_id,
                     budget_left=st.budget_left)

    # ---------------------------------------------------- placement ladder
    def brownout_active(self, expander_id: int) -> bool:
        st = self._links.get(expander_id)
        if st is None:
            return False
        return ((self.now_s < st.brownout_until
                 and st.brownout_factor > 1.0)
                or self.now_s < st.retrain_until)

    def degrade_view(self, expander_id: int, utilization: float) -> float:
        """Placement-view utilization through the fault lens: a
        browned-out (or retraining) expander reports a saturated link,
        so placement and migration steer new pages elsewhere for the
        window — rung two of the degradation ladder."""
        if self.brownout_active(expander_id):
            return max(utilization, BROWNOUT_VIEW_UTILIZATION)
        return utilization

    # ----------------------------------------------------------- telemetry
    def counters(self) -> Dict[str, float]:
        """Aggregate fault counters.  ``retry_bytes`` reconciles exactly
        with ``fm.op_bytes()["retry"]``."""
        agg = {"transient_errors": 0, "retries": 0, "retry_bytes": 0,
               "retry_delay_s": 0.0, "brownout_delay_s": 0.0,
               "flap_delay_s": 0.0, "escalations": 0}
        for st in self._links.values():
            agg["transient_errors"] += st.transient_errors
            agg["retries"] += st.retries
            agg["retry_bytes"] += st.retry_bytes
            agg["retry_delay_s"] += st.retry_delay_s
            agg["brownout_delay_s"] += st.brownout_delay_s
            agg["flap_delay_s"] += st.flap_delay_s
            agg["escalations"] += st.escalations
        return agg

    def snapshot(self) -> dict:
        return {
            "now_s": self.now_s,
            "events_fired": self._next_event,
            "events_total": len(self._events),
            "counters": self.counters(),
            "links": {
                eid: {
                    "error_active": self.now_s < st.error_until,
                    "brownout_active": self.brownout_active(eid),
                    "retraining": self.now_s < st.retrain_until,
                    "budget_left": st.budget_left,
                    "escalated": st.escalated,
                    "retries": st.retries,
                    "transient_errors": st.transient_errors,
                }
                for eid, st in sorted(self._links.items())
            },
        }
