"""Weighted-fair link arbiter: per-expander bandwidth as a scheduled resource.

The seed modeled every consumer as alone on the CXL link; the paper's
scalability claim (one expander supplementing *many* PCIe devices, §3,
Table 1) makes the link a contended resource.  This module arbitrates it
two ways, matching how the Fabric Manager uses it:

  * **planning** — :meth:`LinkArbiter.allocate` answers "given these
    per-tenant demands (B/s), who gets how much of the link?" by weighted
    max-min fairness (progressive water-filling).  Used by the multi-device
    simulator and the SLO admission controller to predict steady state.
  * **metering** — :meth:`LinkArbiter.meter` charges an individual transfer
    against the tenant's token bucket and the shared wire, returning the
    modeled delay.  Used on LinkedBuffer's demote/fault paths so paging
    traffic shows up as link occupancy.  ``nbytes`` is arbitrary, so a
    coalesced multi-page burst is ONE meter call with the burst's total
    bytes — fairness accounting is byte-denominated (token bucket +
    weighted refill), so a burst charge is exactly equivalent to N
    back-to-back page charges, minus N-1 arbiter round-trips.
    :attr:`LinkArbiter.meter_calls` counts the round-trips, which is how
    the ``gather_sweep`` benchmark proves the batched data path amortizes
    arbitration (doorbells, in hardware terms) over bursts.

Time here is *virtual* (deterministic, driven by metered transfers), so
tests and the simulator get exact, reproducible schedules — no wall clock.

This module stays free of ``repro_torch.core`` imports: ``core.fabric`` imports
it (the FM owns a LinkArbiter), so depending on core here would be a
cycle.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


class UnknownTenant(KeyError):
    pass


@dataclasses.dataclass
class TenantState:
    """Arbiter-side accounting for one tenant (a device or a host)."""

    tenant_id: str
    weight: float = 1.0
    #: token-bucket burst allowance; 0 disables the bucket (pure FIFO wire)
    burst_bytes: int = 0
    tokens: float = 0.0
    last_refill_s: float = 0.0
    bytes_total: int = 0
    busy_s: float = 0.0
    wait_s: float = 0.0

    def goodput_Bps(self, elapsed_s: float) -> float:
        return self.bytes_total / elapsed_s if elapsed_s > 0 else 0.0


@dataclasses.dataclass(frozen=True)
class TransferGrant:
    """Outcome of metering one transfer through the link."""

    tenant_id: str
    nbytes: int
    start_s: float          # when the wire picked the transfer up
    completion_s: float     # when the last byte arrived
    delay_s: float          # completion - submission (queue + wire)


def weighted_max_min(demands_Bps: Dict[str, float],
                     weights: Dict[str, float],
                     capacity_Bps: float) -> Dict[str, float]:
    """Weighted max-min fair allocation (progressive water-filling).

    Tenants demanding less than their weighted fair share are fully
    satisfied; the surplus is re-divided among the rest by weight.
    Guarantees ``sum(grants) <= capacity_Bps`` and ``grant <= demand``.
    """
    grants = {t: 0.0 for t in demands_Bps}
    active = {t: d for t, d in demands_Bps.items() if d > 0}
    remaining = capacity_Bps
    while active and remaining > 1e-9:
        total_w = sum(weights.get(t, 1.0) for t in active)
        share = {t: remaining * weights.get(t, 1.0) / total_w for t in active}
        satisfied = [t for t in active if active[t] <= share[t] + 1e-12]
        if not satisfied:
            for t in active:
                grants[t] = share[t]
            return grants
        for t in satisfied:
            grants[t] = active[t]
            remaining -= active[t]
            del active[t]
    return grants


class LinkArbiter:
    """Schedules per-tenant transfer demand onto one expander's link."""

    def __init__(self, link_bandwidth_Bps: float, *,
                 ewma_alpha: float = 0.2):
        if link_bandwidth_Bps <= 0:
            raise ValueError("link bandwidth must be positive")
        self.link_bandwidth_Bps = float(link_bandwidth_Bps)
        self._tenants: Dict[str, TenantState] = {}
        self._ewma_alpha = ewma_alpha
        self._now_s = 0.0           # virtual clock
        self._busy_until_s = 0.0    # wire free time
        self._busy_accum_s = 0.0
        self._prev_completion_s = 0.0
        self._util_ewma = 0.0
        #: arbitration round-trips (one per meter() call, whatever the
        #: burst size) — the per-transfer overhead the batched data path
        #: amortizes; NOT bytes (those are in TenantState.bytes_total)
        self.meter_calls = 0

    # -- tenant management ---------------------------------------------------
    def register(self, tenant_id: str, weight: float = 1.0,
                 burst_bytes: int = 0) -> None:
        if weight <= 0:
            raise ValueError("tenant weight must be positive")
        st = self._tenants.get(tenant_id)
        if st is None:
            self._tenants[tenant_id] = TenantState(
                tenant_id, weight=weight, burst_bytes=burst_bytes,
                tokens=float(burst_bytes), last_refill_s=self._now_s)
        else:
            st.weight, st.burst_bytes = weight, burst_bytes

    def unregister(self, tenant_id: str) -> None:
        self._tenants.pop(tenant_id, None)

    def set_weight(self, tenant_id: str, weight: float) -> None:
        self._tenant(tenant_id).weight = float(weight)

    def _tenant(self, tenant_id: str) -> TenantState:
        st = self._tenants.get(tenant_id)
        if st is None:
            raise UnknownTenant(f"tenant {tenant_id} not registered")
        return st

    def fair_rate_Bps(self, tenant_id: str) -> float:
        """This tenant's weighted share of the raw link (its refill rate)."""
        st = self._tenant(tenant_id)
        total_w = sum(t.weight for t in self._tenants.values())
        return self.link_bandwidth_Bps * st.weight / total_w

    # -- planning: steady-state shares ---------------------------------------
    def allocate(self, demands_Bps: Dict[str, float]) -> Dict[str, float]:
        """Weighted max-min grants for a set of sustained demands."""
        weights = {t: self._tenant(t).weight for t in demands_Bps}
        return weighted_max_min(demands_Bps, weights,
                                self.link_bandwidth_Bps)

    # -- metering: individual transfers --------------------------------------
    def meter(self, tenant_id: str, nbytes: int,
              now_s: Optional[float] = None) -> TransferGrant:
        """Charge one ``nbytes`` transfer; returns its modeled schedule.

        A transfer first draws burst credit from the tenant's token bucket
        (refilled at the tenant's weighted fair rate); a drained bucket
        waits for tokens.  It then serializes on the shared wire at the raw
        link bandwidth.
        """
        st = self._tenant(tenant_id)
        self.meter_calls += 1
        now = self._now_s if now_s is None else max(now_s, self._now_s)
        self._now_s = now
        token_ready = now
        if st.burst_bytes > 0:
            rate = self.fair_rate_Bps(tenant_id)
            st.tokens = min(float(st.burst_bytes),
                            st.tokens + rate * (now - st.last_refill_s))
            st.last_refill_s = now
            if st.tokens >= nbytes:
                st.tokens -= nbytes
            else:
                deficit = nbytes - st.tokens
                token_ready = now + deficit / rate
                st.tokens = 0.0
                st.last_refill_s = token_ready
        wire_s = nbytes / self.link_bandwidth_Bps
        start = max(token_ready, self._busy_until_s)
        completion = start + wire_s
        self._busy_until_s = completion
        self._busy_accum_s += wire_s
        st.bytes_total += nbytes
        st.busy_s += wire_s
        st.wait_s += start - now
        # instantaneous utilization = wire-busy fraction of the window
        # between consecutive completions: back-to-back (queued) transfers
        # give 1.0, sparse traffic gives wire/gap -> 0
        inst = wire_s / max(completion - self._prev_completion_s, wire_s)
        self._prev_completion_s = completion
        self._util_ewma += self._ewma_alpha * (inst - self._util_ewma)
        return TransferGrant(tenant_id, nbytes, start, completion,
                             completion - now)

    def advance(self, dt_s: float) -> None:
        """Let virtual time pass with the link idle (drains the queue)."""
        self._now_s += max(dt_s, 0.0)

    # -- introspection -------------------------------------------------------
    def utilization(self) -> float:
        """EWMA of instantaneous link utilization (1.0 = always queued)."""
        return self._util_ewma

    def cumulative_utilization(self) -> float:
        horizon = max(self._busy_until_s, self._now_s)
        return self._busy_accum_s / horizon if horizon > 0 else 0.0

    def goodput_Bps(self, tenant_id: str) -> float:
        horizon = max(self._busy_until_s, self._now_s)
        return self._tenant(tenant_id).goodput_Bps(horizon)

    def snapshot(self) -> dict:
        return {
            "link_bandwidth_Bps": self.link_bandwidth_Bps,
            "utilization_ewma": self._util_ewma,
            "utilization_cumulative": self.cumulative_utilization(),
            "meter_calls": self.meter_calls,
            "tenants": {
                t: {"weight": s.weight, "bytes_total": s.bytes_total,
                    "busy_s": s.busy_s, "wait_s": s.wait_s}
                for t, s in self._tenants.items()
            },
        }


def jain_fairness(values: Dict[str, float] | list) -> float:
    """Jain's index over per-tenant goodputs: 1.0 = perfectly fair."""
    xs = list(values.values()) if isinstance(values, dict) else list(values)
    if not xs or all(x == 0 for x in xs):
        return 1.0
    num = sum(xs) ** 2
    den = len(xs) * sum(x * x for x in xs)
    return num / den if den else 1.0
