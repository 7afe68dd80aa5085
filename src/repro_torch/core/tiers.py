"""Memory-tier registry and latency/bandwidth model.

Encodes the paper's Figure 2 latency estimates plus the TPU-side constants we
adapt them to.  Every tier is described by an access latency (per transaction)
and a streaming bandwidth; the cost model is used by

  * the discrete-event SSD simulator (``repro_torch.sim``) — with the paper's
    CXL/PCIe constants, to reproduce Fig 6, and
  * the serving/training schedulers — with TPU constants, to decide
    eviction/prefetch and to predict whether paging can hide behind compute.

All latencies in seconds, bandwidths in bytes/second.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict


class TierKind(enum.Enum):
    """Physical tier classes, ordered fastest-first."""

    ONBOARD = "onboard"          # device-local DRAM / TPU HBM
    LMB_CXL = "lmb_cxl"          # CXL P2P path to the expander (direct)
    LMB_PCIE_GEN4 = "lmb_pcie4"  # host-forwarded path, PCIe Gen4 device
    LMB_PCIE_GEN5 = "lmb_pcie5"  # host-forwarded path, PCIe Gen5 device
    HOST_DRAM = "host_dram"      # plain host memory over PCIe (HMB-style)
    FLASH = "flash"              # NAND flash (DFTL fallback)


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """Cost description of one memory tier."""

    kind: TierKind
    #: extra latency per access vs. the onboard tier (paper Fig 2 / §4)
    added_latency_s: float
    #: sustainable streaming bandwidth for bulk page moves
    bandwidth_Bps: float
    #: capacity available in this tier (None = unbounded for modeling)
    capacity_bytes: int | None = None

    def access_time(self, nbytes: int, utilization: float = 0.0) -> float:
        """Latency + transfer time for an ``nbytes`` access.

        ``utilization`` is the load on the shared link behind this tier
        (0 = uncontended, the seed behaviour).  The fixed
        ``added_latency_s`` inflates with queueing delay per
        :func:`congested_latency`; the transfer term stays nominal because
        bandwidth *shares* are the arbiter's job (repro_torch.qos.arbiter), not
        the per-access cost model's.
        """
        return (congested_latency(self.added_latency_s, utilization)
                + nbytes / self.bandwidth_Bps)


def tier_over_path(tier: TierSpec, path) -> TierSpec:
    """``tier`` as seen across a rack fabric path: the path's hop latency
    adds to every access and its bottleneck bandwidth caps streaming.

    ``path`` is duck-typed (``latency_s`` + ``bandwidth_Bps``, i.e. a
    :class:`repro_torch.rack.topology.PathCost` — tiers sits below rack in the
    layering, so no import).  A zero-latency path whose bandwidth matches
    the tier returns an equal spec: direct attach is the degenerate case.
    """
    return dataclasses.replace(
        tier,
        added_latency_s=tier.added_latency_s + path.latency_s,
        bandwidth_Bps=min(tier.bandwidth_Bps, path.bandwidth_Bps))


# ---------------------------------------------------------------------------
# Shared-link congestion (repro_torch.qos)
# ---------------------------------------------------------------------------

#: utilization is clamped here so the M/M/1-style queueing term stays finite
#: even when demand exceeds link capacity (rho >= 1 in the open model)
CONGESTION_RHO_MAX = 0.97
#: how strongly queueing delay scales with utilization; 1.0 = M/M/1 waiting
#: time (W = rho/(1-rho) service times) — CXL fabric measurements (Samsung
#: CMM-H characterization; Zhong et al. pooling study) sit near this shape
CONGESTION_SENSITIVITY = 1.0


def congested_latency(base_latency_s: float, utilization: float,
                      sensitivity: float = CONGESTION_SENSITIVITY) -> float:
    """Effective access latency on a shared link at ``utilization``.

    Monotone non-decreasing in ``utilization`` and equal to
    ``base_latency_s`` at zero load — the seed's fixed-latency model is the
    uncontended special case.  Used by the Fig-6 multi-device simulator and
    the serving admission controller (repro_torch.qos.slo).
    """
    rho = min(max(utilization, 0.0), CONGESTION_RHO_MAX)
    return base_latency_s * (1.0 + sensitivity * rho / (1.0 - rho))


# ---------------------------------------------------------------------------
# Paper constants (Fig 2, §4 "Prototype implementation")
# ---------------------------------------------------------------------------

#: CXL port latency (Sharma, HOTI'22)
CXL_PORT_LATENCY_S = 25e-9
#: CXL switch + HDM access (Pond, ASPLOS'23)
CXL_SWITCH_HDM_LATENCY_S = 70e-9
#: PCIe 5.0 device accessing host memory (Fig 2)
PCIE5_HOST_ACCESS_S = 780e-9

#: Added L2P-lookup latencies used by the paper's simulation (§4):
DFTL_FLASH_READ_S = 25e-6       # one flash read per L2P miss
LMB_CXL_ADDED_S = 190e-9        # CXL device → expander, P2P
LMB_PCIE_GEN4_ADDED_S = 880e-9  # PCIe Gen4 device, host-forwarded
LMB_PCIE_GEN5_ADDED_S = 1190e-9 # PCIe Gen5 device, host-forwarded


def paper_tiers() -> Dict[TierKind, TierSpec]:
    """Tier table with the paper's constants (used by the Fig 6 simulator)."""
    return {
        TierKind.ONBOARD: TierSpec(TierKind.ONBOARD, 0.0, 50e9),
        TierKind.LMB_CXL: TierSpec(TierKind.LMB_CXL, LMB_CXL_ADDED_S, 30e9),
        TierKind.LMB_PCIE_GEN4: TierSpec(
            TierKind.LMB_PCIE_GEN4, LMB_PCIE_GEN4_ADDED_S, 16e9),
        TierKind.LMB_PCIE_GEN5: TierSpec(
            TierKind.LMB_PCIE_GEN5, LMB_PCIE_GEN5_ADDED_S, 32e9),
        TierKind.HOST_DRAM: TierSpec(
            TierKind.HOST_DRAM, PCIE5_HOST_ACCESS_S, 32e9),
        TierKind.FLASH: TierSpec(TierKind.FLASH, DFTL_FLASH_READ_S, 3e9),
    }


# ---------------------------------------------------------------------------
# TPU adaptation constants (v5e target; see DESIGN.md §2)
# ---------------------------------------------------------------------------

#: peak bf16 FLOP/s per chip
TPU_PEAK_FLOPS = 197e12
#: HBM bandwidth per chip
TPU_HBM_BW_Bps = 819e9
#: ICI bandwidth per link
TPU_ICI_BW_Bps = 50e9
#: host<->device PCIe bandwidth (the "LMB pool" path on a TPU host)
TPU_PCIE_BW_Bps = 32e9
#: HBM capacity per v5e chip
TPU_HBM_BYTES = 16 * 2**30
#: PCIe DMA kick-off latency (the TPU analogue of the CXL added latency)
TPU_PCIE_LATENCY_S = 2e-6


def tpu_tiers(host_pool_bytes: int | None = None) -> Dict[TierKind, TierSpec]:
    """Tier table for the TPU adaptation: HBM = onboard, host pool = LMB."""
    return {
        TierKind.ONBOARD: TierSpec(
            TierKind.ONBOARD, 0.0, TPU_HBM_BW_Bps, TPU_HBM_BYTES),
        TierKind.HOST_DRAM: TierSpec(
            TierKind.HOST_DRAM, TPU_PCIE_LATENCY_S, TPU_PCIE_BW_Bps,
            host_pool_bytes),
    }


def hideable_page_bytes(compute_time_s: float,
                        tier: TierSpec,
                        streams: int = 1) -> int:
    """How many bytes can be paged from ``tier`` while compute runs.

    Used by the prefetcher: paging is "free" (hidden) as long as the bytes
    moved per step stay under this bound.  ``streams`` models multiple DMA
    engines.
    """
    usable = max(compute_time_s - tier.added_latency_s, 0.0)
    return int(usable * tier.bandwidth_Bps * streams)
