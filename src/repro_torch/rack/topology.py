"""Switched rack topology: hosts x expanders x switch tiers.

"My CXL Pool Obviates Your PCIe Switch" (Zhong et al., arXiv 2503.23611)
argues that pool-level topology — many hosts and many expanders behind a
shared switched fabric — changes the placement, failover, and bandwidth
calculus entirely; the CXL interconnect introduction (Das Sharma et al.)
supplies the structure we model: ports with fixed crossing latency,
switches with per-tier hop latency, and links with per-port bandwidth.

The model is a forest of switches.  Hosts and expanders attach to
switches by edges; switches attach to parent switches (uplinks) by
edges.  Every edge carries a hop latency and a port bandwidth.  A
:meth:`RackTopology.path` walks host -> ... -> common ancestor ->
... -> expander and returns a :class:`PathCost`:

  * ``hops``          — number of switches traversed (1 = same leaf =
                        the direct-attach degenerate case),
  * ``latency_s``     — sum of per-edge hop latencies (what
                        :func:`repro_torch.core.tiers.tier_over_path` folds
                        into a TierSpec's added latency),
  * ``bandwidth_Bps`` — bottleneck (min) edge bandwidth (what the
                        per-link arbiters consume).

Correlated failure domains: every expander belongs to a failure domain
(explicit, or inherited from its switch's power domain, or defaulting
to ``switch:<name>``) — a switch or power domain failing takes out
every expander behind it.  :meth:`expanders_in_domain` is what
``FabricManager.inject_domain_failure`` uses to fail them together.

Direct attach (today's single-expander model) falls out as the 1-switch
degenerate case built by :meth:`RackTopology.direct`: zero-latency
attach edges through one virtual switch, so a FabricManager given that
topology behaves exactly like one without a topology.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.tiers import CXL_PORT_LATENCY_S, CXL_SWITCH_HDM_LATENCY_S

#: default per-port bandwidth (matches the LMB_CXL tier / fabric default)
DEFAULT_PORT_BW_Bps = 30e9
#: default host/expander attach-edge latency (one CXL port crossing)
ATTACH_LATENCY_S = CXL_PORT_LATENCY_S
#: default switch-to-switch uplink latency (switch + HDM decode hop)
UPLINK_LATENCY_S = CXL_SWITCH_HDM_LATENCY_S


@dataclasses.dataclass(frozen=True)
class PathCost:
    """Cost of one host->expander path through the fabric."""

    #: switches traversed; 1 = same leaf (direct-attach degenerate case)
    hops: int
    #: sum of per-edge hop latencies along the path
    latency_s: float
    #: bottleneck (min) per-port bandwidth along the path
    bandwidth_Bps: float


@dataclasses.dataclass(frozen=True)
class _Edge:
    """One attachment (node -> switch) or uplink (switch -> switch)."""

    to_switch: str
    latency_s: float
    bandwidth_Bps: float


class TopologyError(ValueError):
    pass


class RackTopology:
    """A rack of hosts and expanders behind a switched CXL fabric."""

    def __init__(self) -> None:
        # switch name -> uplink edge (None = root of its tree)
        self._switches: Dict[str, Optional[_Edge]] = {}
        self._switch_power: Dict[str, Optional[str]] = {}
        self._hosts: Dict[str, _Edge] = {}
        self._expanders: Dict[int, _Edge] = {}
        self._expander_domain: Dict[int, str] = {}
        self._expander_capacity: Dict[int, Optional[int]] = {}
        self._path_cache: Dict[Tuple[str, int], PathCost] = {}

    # -- construction --------------------------------------------------------
    def add_switch(self, name: str, *, uplink: Optional[str] = None,
                   latency_s: float = UPLINK_LATENCY_S,
                   bandwidth_Bps: float = DEFAULT_PORT_BW_Bps,
                   power_domain: Optional[str] = None) -> "RackTopology":
        """Add a switch tier node; ``uplink`` chains it under a parent
        (leaf -> spine).  ``power_domain`` is the correlated-failure
        domain every expander behind this switch inherits by default."""
        if name in self._switches:
            raise TopologyError(f"duplicate switch {name!r}")
        if uplink is not None and uplink not in self._switches:
            raise TopologyError(f"uplink switch {uplink!r} unknown")
        self._switches[name] = (
            _Edge(uplink, latency_s, bandwidth_Bps)
            if uplink is not None else None)
        self._switch_power[name] = power_domain
        return self

    def attach_host(self, host_id: str, switch: str, *,
                    latency_s: float = ATTACH_LATENCY_S,
                    bandwidth_Bps: float = DEFAULT_PORT_BW_Bps,
                    ) -> "RackTopology":
        if switch not in self._switches:
            raise TopologyError(f"switch {switch!r} unknown")
        self._hosts[host_id] = _Edge(switch, latency_s, bandwidth_Bps)
        self._path_cache.clear()
        return self

    def attach_expander(self, expander_id: int, switch: str, *,
                        latency_s: float = ATTACH_LATENCY_S,
                        bandwidth_Bps: float = DEFAULT_PORT_BW_Bps,
                        domain: Optional[str] = None,
                        capacity_bytes: Optional[int] = None,
                        ) -> "RackTopology":
        """Attach an expander.  Failure domain precedence: explicit
        ``domain`` > the switch's ``power_domain`` > ``switch:<name>``
        (a switch failing takes out everything behind it either way)."""
        if switch not in self._switches:
            raise TopologyError(f"switch {switch!r} unknown")
        eid = int(expander_id)
        self._expanders[eid] = _Edge(switch, latency_s, bandwidth_Bps)
        self._expander_domain[eid] = (
            domain or self._switch_power[switch] or f"switch:{switch}")
        self._expander_capacity[eid] = capacity_bytes
        self._path_cache.clear()
        return self

    # -- introspection -------------------------------------------------------
    @property
    def host_ids(self) -> List[str]:
        return list(self._hosts)

    @property
    def expander_ids(self) -> List[int]:
        return list(self._expanders)

    @property
    def switch_names(self) -> List[str]:
        return list(self._switches)

    def domain_of(self, expander_id: int) -> str:
        dom = self._expander_domain.get(int(expander_id))
        if dom is None:
            raise TopologyError(f"expander {expander_id} not in topology")
        return dom

    def domains(self) -> Dict[str, List[int]]:
        """failure domain -> expander ids (sorted), covering the rack."""
        out: Dict[str, List[int]] = {}
        for eid, dom in self._expander_domain.items():
            out.setdefault(dom, []).append(eid)
        return {dom: sorted(eids) for dom, eids in sorted(out.items())}

    def expanders_in_domain(self, domain: str) -> List[int]:
        """Correlated failure set: every expander the domain takes out."""
        eids = self.domains().get(domain)
        if eids is None:
            raise TopologyError(f"unknown failure domain {domain!r}")
        return eids

    def port_bandwidth_Bps(self, expander_id: int) -> float:
        edge = self._expanders.get(int(expander_id))
        if edge is None:
            raise TopologyError(f"expander {expander_id} not in topology")
        return edge.bandwidth_Bps

    def pool_capacity_bytes(self, domain: Optional[str] = None) -> int:
        """Declared capacity of the pool (or one failure domain's slice);
        expanders attached without a capacity count as zero."""
        eids = (self.expanders_in_domain(domain) if domain is not None
                else self.expander_ids)
        return sum(self._expander_capacity.get(e) or 0 for e in eids)

    # -- path cost -----------------------------------------------------------
    def _ancestry(self, switch: str) -> List[Tuple[str, Optional[_Edge]]]:
        """(switch, uplink-edge) chain from ``switch`` to its root."""
        chain = []
        cur: Optional[str] = switch
        seen = set()
        while cur is not None:
            if cur in seen:
                raise TopologyError(f"uplink cycle through {cur!r}")
            seen.add(cur)
            edge = self._switches[cur]
            chain.append((cur, edge))
            cur = edge.to_switch if edge is not None else None
        return chain

    def path(self, host_id: str, expander_id: int) -> PathCost:
        """Cost of the host->expander path (cached).

        Walks host attach edge, uplinks to the lowest common ancestor
        switch, then down to the expander's attach edge.  Raises
        :class:`TopologyError` when the two sit in disjoint trees."""
        eid = int(expander_id)
        key = (host_id, eid)
        hit = self._path_cache.get(key)
        if hit is not None:
            return hit
        h_edge = self._hosts.get(host_id)
        if h_edge is None:
            raise TopologyError(f"host {host_id!r} not in topology")
        x_edge = self._expanders.get(eid)
        if x_edge is None:
            raise TopologyError(f"expander {eid} not in topology")
        up = self._ancestry(h_edge.to_switch)
        down = self._ancestry(x_edge.to_switch)
        down_names = {name: i for i, (name, _) in enumerate(down)}
        lca_i = next((i for i, (name, _) in enumerate(up)
                      if name in down_names), None)
        if lca_i is None:
            raise TopologyError(
                f"no fabric path {host_id!r} -> expander {eid}")
        lat = h_edge.latency_s + x_edge.latency_s
        bw = min(h_edge.bandwidth_Bps, x_edge.bandwidth_Bps)
        # uplink edges host-side below the LCA, then expander-side below
        hops = 1                                  # the LCA switch itself
        for _, edge in up[:lca_i]:
            lat += edge.latency_s
            bw = min(bw, edge.bandwidth_Bps)
            hops += 1
        for _, edge in down[:down_names[up[lca_i][0]]]:
            lat += edge.latency_s
            bw = min(bw, edge.bandwidth_Bps)
            hops += 1
        cost = PathCost(hops=hops, latency_s=lat, bandwidth_Bps=bw)
        self._path_cache[key] = cost
        return cost

    # -- canned shapes -------------------------------------------------------
    @classmethod
    def direct(cls, expander_ids: Sequence[int] = (0,),
               hosts: Sequence[str] = ("h0",),
               bandwidth_Bps: float = DEFAULT_PORT_BW_Bps,
               ) -> "RackTopology":
        """Degenerate 1-switch rack: every host and expander on one
        zero-latency virtual switch — path cost (hops=1, 0 s, link bw),
        i.e. exactly today's direct-attach model."""
        topo = cls()
        topo.add_switch("root", bandwidth_Bps=bandwidth_Bps)
        for h in hosts:
            topo.attach_host(h, "root", latency_s=0.0,
                             bandwidth_Bps=bandwidth_Bps)
        for eid in expander_ids:
            topo.attach_expander(int(eid), "root", latency_s=0.0,
                                 bandwidth_Bps=bandwidth_Bps)
        return topo

    @classmethod
    def two_tier(cls, n_leaves: int, expanders_per_leaf: int,
                 hosts_per_leaf: int = 1, *,
                 port_bandwidth_Bps: float = DEFAULT_PORT_BW_Bps,
                 spine_bandwidth_Bps: Optional[float] = None,
                 attach_latency_s: float = ATTACH_LATENCY_S,
                 uplink_latency_s: float = UPLINK_LATENCY_S,
                 capacity_bytes: Optional[int] = None,
                 ) -> "RackTopology":
        """Spine/leaf rack: one spine switch, ``n_leaves`` leaf switches,
        ``expanders_per_leaf`` expanders and ``hosts_per_leaf`` hosts per
        leaf.  Expander ids are dense (leaf-major); hosts are named
        ``h<k>`` leaf-major.  Each leaf is its own power/failure domain
        (``pd<leaf>``): a leaf switch dying takes out every expander
        behind it.  Same-leaf paths cost 1 hop; cross-leaf paths cost 3
        (leaf -> spine -> leaf)."""
        if n_leaves < 1 or expanders_per_leaf < 1 or hosts_per_leaf < 0:
            raise TopologyError("two_tier needs >=1 leaf and expander")
        topo = cls()
        spine_bw = (spine_bandwidth_Bps if spine_bandwidth_Bps is not None
                    else port_bandwidth_Bps)
        topo.add_switch("spine", bandwidth_Bps=spine_bw)
        for leaf in range(n_leaves):
            topo.add_switch(f"leaf{leaf}", uplink="spine",
                            latency_s=uplink_latency_s,
                            bandwidth_Bps=spine_bw,
                            power_domain=f"pd{leaf}")
            for i in range(hosts_per_leaf):
                topo.attach_host(f"h{leaf * hosts_per_leaf + i}",
                                 f"leaf{leaf}",
                                 latency_s=attach_latency_s,
                                 bandwidth_Bps=port_bandwidth_Bps)
            for i in range(expanders_per_leaf):
                topo.attach_expander(leaf * expanders_per_leaf + i,
                                     f"leaf{leaf}",
                                     latency_s=attach_latency_s,
                                     bandwidth_Bps=port_bandwidth_Bps,
                                     capacity_bytes=capacity_bytes)
        return topo

    def snapshot(self) -> dict:
        return {
            "switches": sorted(self._switches),
            "hosts": sorted(self._hosts),
            "expanders": sorted(self._expanders),
            "domains": self.domains(),
        }
