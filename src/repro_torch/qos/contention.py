"""Congestion-aware tier costs: effective latency as f(link utilization).

The seed's :class:`~repro_torch.core.tiers.TierSpec` carries a *fixed*
``added_latency_s`` — correct for one device on an idle link (the paper's
Fig-6 setup) and wrong for the regime the paper actually argues for (many
devices per expander).  This module replaces the fixed constant on hot
paths with an effective latency derived from observed or predicted link
utilization, using the queueing shape in
:func:`repro_torch.core.tiers.congested_latency`.

``LinkState`` is the glue: consumers feed it metered transfer bytes (from
the :class:`~repro_torch.qos.arbiter.LinkArbiter`) or a predicted demand total,
and cost-model callers read a utilization scalar from it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.tiers import TierKind, TierSpec, congested_latency


@dataclasses.dataclass
class LinkState:
    """Tracks one shared link's load as a utilization scalar in [0, 1].

    Two feeding modes, composable:
      * ``observe_bytes`` — EWMA over metered transfer windows (runtime);
      * ``set_demand``    — offered-load prediction (planning/simulation).
    """

    link_bandwidth_Bps: float
    ewma_alpha: float = 0.3
    _util: float = 0.0

    def observe_bytes(self, nbytes: int, window_s: float) -> None:
        if window_s <= 0:
            return
        inst = min(nbytes / (self.link_bandwidth_Bps * window_s), 1.0)
        self._util += self.ewma_alpha * (inst - self._util)

    def set_demand(self, demand_Bps: float) -> None:
        self._util = min(max(demand_Bps, 0.0) / self.link_bandwidth_Bps, 1.0)

    @property
    def utilization(self) -> float:
        return self._util


@dataclasses.dataclass(frozen=True)
class ContendedTierSpec:
    """A TierSpec whose access cost reads live congestion off a LinkState.

    Drop-in for :class:`TierSpec` on hot paths: same ``kind`` /
    ``bandwidth_Bps`` / ``capacity_bytes`` attributes, but ``access_time``
    and ``added_latency_s`` reflect the current link load instead of the
    uncontended constant.
    """

    base: TierSpec
    link: LinkState

    @property
    def kind(self) -> TierKind:
        return self.base.kind

    @property
    def bandwidth_Bps(self) -> float:
        return self.base.bandwidth_Bps

    @property
    def capacity_bytes(self) -> Optional[int]:
        return self.base.capacity_bytes

    @property
    def added_latency_s(self) -> float:
        """Effective (congested) added latency at the current link load."""
        return congested_latency(self.base.added_latency_s,
                                 self.link.utilization)

    def access_time(self, nbytes: int,
                    utilization: Optional[float] = None) -> float:
        rho = self.link.utilization if utilization is None else utilization
        return self.base.access_time(nbytes, utilization=rho)


def contended_tiers(tiers: Dict[TierKind, TierSpec],
                    link: LinkState,
                    shared_kinds: Optional[set] = None,
                    ) -> Dict[TierKind, TierSpec | ContendedTierSpec]:
    """Wrap the tiers that sit behind the shared expander link.

    Onboard memory and flash are device-local and keep their fixed costs;
    every LMB path (CXL P2P or host-forwarded) and host DRAM contend.
    """
    if shared_kinds is None:
        shared_kinds = {TierKind.LMB_CXL, TierKind.LMB_PCIE_GEN4,
                        TierKind.LMB_PCIE_GEN5, TierKind.HOST_DRAM}
    return {k: (ContendedTierSpec(spec, link) if k in shared_kinds else spec)
            for k, spec in tiers.items()}
