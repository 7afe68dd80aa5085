"""repro_torch.qos — shared-fabric contention and multi-tenant QoS.

The paper's scalability story (one expander behind many PCIe devices)
makes the CXL link a contended, arbitrated resource.  Three layers:

  arbiter    — weighted-fair / token-bucket scheduling of per-tenant
               transfer demand onto per-expander link bandwidth
  contention — effective tier latency as a function of link utilization
               (replaces the fixed added_latency_s on hot paths)
  slo        — per-tenant SLO tracking + admit/throttle/shed control
  migration  — hot-page migration between pooled expanders (saturation-
               triggered, heat-ranked, journaled like DCD events)

Wired through: FabricManager owns a LinkArbiter next to its capacity
quotas, LinkedBuffer meters paging traffic through it, the Fig-6
simulator grows a multi-device shared-fabric mode, and the serving
engine routes admission through the SLO controller.
"""

# arbiter must come first: it is core-free, and importing contention/slo
# below pulls in repro_torch.core, whose fabric module imports repro_torch.qos.arbiter
from repro_torch.qos.arbiter import (LinkArbiter, TenantState, TransferGrant,
                               UnknownTenant, jain_fairness,
                               weighted_max_min)
from repro_torch.qos.contention import (ContendedTierSpec, LinkState,
                                  contended_tiers)
from repro_torch.qos.migration import (MigrationEngine, MigrationPolicy,
                                 MigrationReport, plan_rebalance)
from repro_torch.qos.slo import (AdmissionController, Decision, SLOTarget,
                           TenantSLO)

__all__ = [
    "LinkArbiter", "TenantState", "TransferGrant", "UnknownTenant",
    "jain_fairness", "weighted_max_min", "ContendedTierSpec", "LinkState",
    "contended_tiers", "AdmissionController", "Decision", "SLOTarget",
    "TenantSLO", "MigrationEngine", "MigrationPolicy", "MigrationReport",
    "plan_rebalance",
]
