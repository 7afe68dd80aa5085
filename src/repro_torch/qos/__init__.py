"""repro_torch.qos — shared-fabric arbitration and SLO admission.

The port carries the two modules its serving path imports (copied from
``repro.qos``): ``arbiter`` (weighted-fair link arbitration, which
``core.fabric`` imports) and ``slo`` (per-tenant admission control).
Contention modelling and hot-page migration come with later slices.
"""

# arbiter must come first: it is core-free, and importing slo below pulls
# in repro_torch.core, whose fabric module imports repro_torch.qos.arbiter
from repro_torch.qos.arbiter import (LinkArbiter, TenantState,
                                     TransferGrant, UnknownTenant,
                                     jain_fairness, weighted_max_min)
from repro_torch.qos.slo import (AdmissionController, Decision, SLOTarget,
                                 TenantSLO)

__all__ = [
    "LinkArbiter", "TenantState", "TransferGrant", "UnknownTenant",
    "jain_fairness", "weighted_max_min", "AdmissionController", "Decision",
    "SLOTarget", "TenantSLO",
]
