"""Per-tenant SLO tracking and congestion-aware admission control.

Closes the QoS loop: the arbiter (repro_torch.qos.arbiter) decides *who gets the
link*, the contention model (repro_torch.qos.contention) decides *what the link
costs*, and this module decides *who gets in at all*.  An
:class:`AdmissionController` holds per-tenant latency targets, predicts
each tenant's p99 under the load the admitted set puts on the shared link,
and answers admit / throttle / shed — the serving engine consults it
before seating a request in a decode slot.

Modeled p99 is intentionally pessimistic-monotone: admitting demand can
only raise everyone's predicted tail (utilization is a sum of admitted
demands and ``congested_latency`` is monotone in it), so incumbents are
never promised an improvement by adding a neighbor.  Tests pin this
property (SLO-admission monotonicity).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional

import numpy as np

from repro_torch.core.tiers import congested_latency
from repro_torch.qos.arbiter import LinkArbiter


class Decision(enum.Enum):
    ADMIT = "admit"          # predicted p99 within target
    THROTTLE = "throttle"    # over target but under the shed line: defer
    SHED = "shed"            # would blow the target even if deferred: reject


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """What a tenant was promised."""

    p99_latency_s: float
    #: predicted p99 above ``shed_factor * p99_latency_s`` rejects outright
    shed_factor: float = 2.0


@dataclasses.dataclass
class TenantSLO:
    """Controller-side record for one tenant."""

    tenant_id: str
    target: SLOTarget
    #: sustained link demand this tenant adds when admitted (B/s)
    demand_Bps: float
    #: uncontended per-request latency floor (tier access + service time)
    base_latency_s: float
    admitted: bool = False
    window: int = 256
    _lat: list = dataclasses.field(default_factory=list)
    admitted_count: int = 0
    throttled_count: int = 0
    shed_count: int = 0
    #: requests cancelled after admission (deadline expiry / capacity loss)
    cancelled_count: int = 0

    def observe(self, latency_s: float) -> None:
        self._lat.append(latency_s)
        if len(self._lat) > self.window:
            del self._lat[: len(self._lat) - self.window]

    def observed_p99(self) -> Optional[float]:
        if not self._lat:
            return None
        return float(np.percentile(np.asarray(self._lat), 99))


class AdmissionController:
    """Admit / throttle / shed tenants against a shared-link budget."""

    def __init__(self, link_bandwidth_Bps: float,
                 default_target: SLOTarget = SLOTarget(p99_latency_s=1.0),
                 arbiter: Optional[LinkArbiter] = None):
        self.link_bandwidth_Bps = float(link_bandwidth_Bps)
        self.default_target = default_target
        self.arbiter = arbiter
        self._tenants: Dict[str, TenantSLO] = {}

    # -- registration --------------------------------------------------------
    def register(self, tenant_id: str, *,
                 target: Optional[SLOTarget] = None,
                 demand_Bps: float = 0.0,
                 base_latency_s: float = 1e-3) -> TenantSLO:
        t = TenantSLO(tenant_id, target or self.default_target,
                      demand_Bps=demand_Bps, base_latency_s=base_latency_s)
        self._tenants[tenant_id] = t
        return t

    def tenant(self, tenant_id: str) -> TenantSLO:
        t = self._tenants.get(tenant_id)
        if t is None:
            t = self.register(tenant_id)
        return t

    # -- load model ----------------------------------------------------------
    def admitted_demand_Bps(self) -> float:
        return sum(t.demand_Bps for t in self._tenants.values() if t.admitted)

    def utilization(self, extra_demand_Bps: float = 0.0) -> float:
        """Predicted link utilization with the admitted set (+ extra)."""
        rho = ((self.admitted_demand_Bps() + extra_demand_Bps)
               / self.link_bandwidth_Bps)
        if self.arbiter is not None:
            # never predict below what the link is already observed doing
            rho = max(rho, self.arbiter.utilization())
        return min(rho, 1.0)

    def modeled_p99(self, tenant_id: str,
                    extra_demand_Bps: float = 0.0) -> float:
        """Tenant's predicted p99 under current admissions (+ extra load).

        Floor is the worse of the tenant's uncontended base latency and its
        *observed* p99; congestion then inflates it.  Monotone in the
        admitted demand by construction.
        """
        t = self.tenant(tenant_id)
        floor = t.base_latency_s
        obs = t.observed_p99()
        if obs is not None:
            floor = max(floor, obs)
        return congested_latency(floor, self.utilization(extra_demand_Bps))

    # -- the decision --------------------------------------------------------
    def decide(self, tenant_id: str) -> Decision:
        """Admit / throttle / shed one unit of ``tenant_id``'s work.

        Admission is evaluated *with* the tenant's demand on the link (an
        un-admitted tenant's demand counts as the extra; an admitted one is
        already in the sum).
        """
        t = self.tenant(tenant_id)
        extra = 0.0 if t.admitted else t.demand_Bps
        p99 = self.modeled_p99(tenant_id, extra_demand_Bps=extra)
        target = t.target.p99_latency_s
        if p99 <= target:
            t.admitted = True
            t.admitted_count += 1
            return Decision.ADMIT
        if p99 <= target * t.target.shed_factor:
            t.throttled_count += 1
            return Decision.THROTTLE
        t.shed_count += 1
        return Decision.SHED

    def release(self, tenant_id: str) -> None:
        """Tenant's work drained; stop counting its demand against the link."""
        self.tenant(tenant_id).admitted = False

    def observe(self, tenant_id: str, latency_s: float) -> None:
        self.tenant(tenant_id).observe(latency_s)

    def record_cancel(self, tenant_id: str) -> None:
        """A previously admitted request was cancelled (deadline expiry or
        mid-flight capacity loss) — counted against the tenant's SLO."""
        self.tenant(tenant_id).cancelled_count += 1

    # -- introspection -------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "link_bandwidth_Bps": self.link_bandwidth_Bps,
            "utilization": self.utilization(),
            "tenants": {
                tid: {
                    "admitted": t.admitted,
                    "demand_Bps": t.demand_Bps,
                    "target_p99_s": t.target.p99_latency_s,
                    "observed_p99_s": t.observed_p99(),
                    "modeled_p99_s": self.modeled_p99(tid),
                    "admitted_count": t.admitted_count,
                    "throttled_count": t.throttled_count,
                    "shed_count": t.shed_count,
                    "cancelled_count": t.cancelled_count,
                }
                for tid, t in self._tenants.items()
            },
        }
