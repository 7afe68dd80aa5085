"""Block→expander placement policies for the pooled fabric.

The CXL pooling literature frames pooled memory as *revocable capability
grants with policy-driven placement* (Das Sharma et al., "An Introduction
to the CXL Interconnect"; Zhong et al., "My CXL Pool Obviates Your PCIe
Switch").  This module is the "policy-driven" half: the Fabric Manager
delegates every unhinted block-placement (and migration-target) decision
to a :class:`PlacementPolicy`, injected through
:class:`repro_torch.core.client.SystemSpec`.

A policy sees only a :class:`PlacementRequest` (who is asking, for what
media, on behalf of which tenant) and a list of :class:`ExpanderView`
candidates (healthy expanders, their free capacity and link heat) — never
the FabricManager itself, so policies can be swapped or unit-tested
without touching fabric internals.

Policies:
  * :class:`LeastLoadedPolicy` — the default; coolest link wins, free
    space breaks ties (the criterion block placement and migration
    targeting shared before this module existed, so behavior under the
    default is unchanged).
  * :class:`HeatAwarePolicy` — capacity-balances across *cool* links
    (most free bytes wins while every link is below ``hot_threshold``),
    falling back to least-loaded once links run hot.  Packs a quiet pool
    by capacity instead of ping-ponging on utilization noise.
  * :class:`TenantAffinityPolicy` — sticky tenant→expander homes
    (seeded explicitly or assigned round-robin on first sight), so one
    tenant's traffic stays off its neighbors' links; falls back to
    least-loaded for tenantless requests or when the home has no room.

This module deliberately imports only ``repro_torch.core.pool`` — it sits
below ``fabric`` in the layering.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Protocol, Sequence, Union, runtime_checkable

from repro_torch.core.pool import MediaKind


@dataclasses.dataclass(frozen=True)
class ExpanderView:
    """What a policy may know about one candidate expander."""

    expander_id: int
    #: free bytes of the requested media on this expander
    free_bytes: int
    #: the expander link's EWMA utilization in [0, 1]
    utilization: float
    #: fabric path latency from the requesting host (rack topology hop
    #: cost); 0.0 = direct attach or no topology configured
    path_latency_s: float = 0.0
    #: correlated failure domain (rack topology); None when unknown
    domain: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class PlacementRequest:
    """One block-placement (or migration-target) question."""

    media: MediaKind = MediaKind.DRAM
    host_id: Optional[str] = None
    #: device the region is being allocated for (None for host-level
    #: re-grants, e.g. the failover path)
    device_id: Optional[str] = None
    #: tenant the device belongs to (from DeviceInfo.tenant), if any
    tenant: Optional[str] = None


@runtime_checkable
class PlacementPolicy(Protocol):
    """Pick an expander for a request; ``None`` means "no preference"
    (the FM then falls back to any healthy expander and lets the grant
    path raise OutOfMemory if the pool is truly full)."""

    name: str

    def choose(self, request: PlacementRequest,
               views: Sequence[ExpanderView]) -> Optional[int]:
        ...  # pragma: no cover - protocol


class LeastLoadedPolicy:
    """Coolest healthy link wins; more free bytes, then lower id, break
    ties.  This is the exact criterion the pre-policy FabricManager
    hard-wired, shared by block placement and migration targeting so the
    two cannot drift."""

    name = "least-loaded"

    def choose(self, request: PlacementRequest,
               views: Sequence[ExpanderView]) -> Optional[int]:
        if not views:
            return None
        best = min(views, key=lambda v: (v.utilization, -v.free_bytes,
                                         v.expander_id))
        return best.expander_id


class HeatAwarePolicy:
    """Capacity-balance while the pool is cool, heat-balance once it is
    not: among links below ``hot_threshold`` the most free bytes wins
    (utilization EWMAs on an idle pool are noise — packing by capacity
    keeps block counts even), otherwise defer to least-loaded."""

    name = "heat-aware"

    def __init__(self, hot_threshold: float = 0.5):
        if not 0.0 < hot_threshold <= 1.0:
            raise ValueError(f"hot_threshold {hot_threshold} not in (0, 1]")
        self.hot_threshold = hot_threshold
        self._fallback = LeastLoadedPolicy()

    def choose(self, request: PlacementRequest,
               views: Sequence[ExpanderView]) -> Optional[int]:
        cool = [v for v in views if v.utilization < self.hot_threshold]
        if cool:
            best = max(cool, key=lambda v: (v.free_bytes, -v.expander_id))
            return best.expander_id
        return self._fallback.choose(request, views)


class TenantAffinityPolicy:
    """Sticky tenant→expander homes.

    A tenant's first placement assigns it a home expander — from the
    ``assignments`` seed (e.g. ``TenantSpec.preferred_expander``) or
    round-robin over the candidates — and every later request for that
    tenant lands there while the home is healthy and has room.  Requests
    with no tenant, and tenants whose home cannot take the block, fall
    back to least-loaded placement."""

    name = "tenant-affinity"

    def __init__(self, assignments: Optional[Dict[str, int]] = None):
        self._assignments: Dict[str, int] = dict(assignments or {})
        self._rr = 0
        self._fallback = LeastLoadedPolicy()

    @property
    def assignments(self) -> Dict[str, int]:
        """tenant → home expander (introspection; a copy)."""
        return dict(self._assignments)

    def choose(self, request: PlacementRequest,
               views: Sequence[ExpanderView]) -> Optional[int]:
        if not views:
            return None
        if request.tenant is None:
            return self._fallback.choose(request, views)
        home = self._assignments.get(request.tenant)
        if home is None:
            ids = sorted(v.expander_id for v in views)
            home = ids[self._rr % len(ids)]
            self._rr += 1
            self._assignments[request.tenant] = home
        if any(v.expander_id == home for v in views):
            return home
        return self._fallback.choose(request, views)


class PoolAwarePolicy:
    """Topology-aware placement for switched racks: the NEAREST cool
    expander wins.

    Among candidates whose link utilization is below ``hot_threshold``,
    the lowest fabric path latency wins (same-leaf beats cross-leaf
    beats cross-spine), with coolest link then most free bytes breaking
    ties.  When every candidate runs hot, distance stops mattering and
    the policy degrades to pure least-loaded — a saturated near link is
    worse than an idle far one.  Without a topology every
    ``path_latency_s`` is 0.0 and this behaves exactly like
    least-loaded."""

    name = "pool-aware"

    def __init__(self, hot_threshold: float = 0.7):
        if not 0.0 < hot_threshold <= 1.0:
            raise ValueError(f"hot_threshold {hot_threshold} not in (0, 1]")
        self.hot_threshold = hot_threshold
        self._fallback = LeastLoadedPolicy()

    def choose(self, request: PlacementRequest,
               views: Sequence[ExpanderView]) -> Optional[int]:
        if not views:
            return None
        cool = [v for v in views if v.utilization < self.hot_threshold]
        if not cool:
            return self._fallback.choose(request, views)
        best = min(cool, key=lambda v: (v.path_latency_s, v.utilization,
                                        -v.free_bytes, v.expander_id))
        return best.expander_id


#: registry for SystemSpec's string-named policies
_POLICIES = {
    LeastLoadedPolicy.name: LeastLoadedPolicy,
    HeatAwarePolicy.name: HeatAwarePolicy,
    TenantAffinityPolicy.name: TenantAffinityPolicy,
    PoolAwarePolicy.name: PoolAwarePolicy,
}


def make_placement_policy(
        policy: Union[str, PlacementPolicy, None], **kwargs
) -> PlacementPolicy:
    """Resolve a policy name (or pass an instance through).  ``None``
    means the default least-loaded policy."""
    if policy is None:
        return LeastLoadedPolicy()
    if isinstance(policy, str):
        cls = _POLICIES.get(policy)
        if cls is None:
            raise ValueError(
                f"unknown placement policy {policy!r}; "
                f"choose from {sorted(_POLICIES)}")
        return cls(**kwargs)
    return policy
