"""repro_torch.core — the CXL Linked Memory Buffer, ported to PyTorch.

Layering (bottom-up), as in ``repro.core``:
  tiers     — latency/bandwidth model of each memory tier (copied)
  pool      — expander + 256 MB block allocator (copied)
  placement — pluggable block→expander placement policies (copied)
  fabric    — Fabric Manager, SAT/IOMMU access control (copied)
  api       — Table-2 kernel API (copied)
  client    — LMBSystem sessions, MemoryHandle capabilities (copied)
  policy    — eviction + prefetch (copied)
  offload   — torch realization of tier moves: device pool + pinned host
  buffer    — LinkedBuffer: paged logical tensors spanning tiers
"""

from repro_torch.core.api import Allocation, LMBHost
from repro_torch.core.buffer import LinkedBuffer
from repro_torch.core.client import (DeviceSpec, ExpanderSpec, HostSpec,
                                     LMBSystem, MemoryHandle, ObsSpec,
                                     PrefetchSpec, StaleHandle, SystemSpec,
                                     TenantSpec, system_for)
from repro_torch.core.fabric import (AccessDenied, DeviceClass, DeviceInfo,
                                     FabricManager, make_default_fabric,
                                     make_multi_fabric)
from repro_torch.core.faults import (FaultEvent, FaultInjector, FaultPlan,
                                     RetryPolicy)
from repro_torch.core.offload import TierExecutor
from repro_torch.core.overlap import (OverlapScheduler, exposed_latency_s,
                                      hidden_fraction)
from repro_torch.core.policy import Prefetcher, PrefetchRun
from repro_torch.core.placement import (ExpanderView, HeatAwarePolicy,
                                        LeastLoadedPolicy, PlacementPolicy,
                                        PlacementRequest,
                                        TenantAffinityPolicy,
                                        make_placement_policy)
from repro_torch.core.pool import (BLOCK_BYTES, BlockAllocator, Expander,
                                   InvalidHandle, LMBError, MediaKind,
                                   OutOfMemory)
from repro_torch.core.tiers import (TierKind, TierSpec, congested_latency,
                                    paper_tiers, tpu_tiers)

__all__ = [
    "Allocation", "LMBHost", "LinkedBuffer", "AccessDenied", "DeviceClass",
    "DeviceInfo", "FabricManager", "make_default_fabric",
    "make_multi_fabric", "TierExecutor", "BLOCK_BYTES", "BlockAllocator",
    "Expander", "InvalidHandle", "LMBError", "MediaKind", "OutOfMemory",
    "TierKind", "TierSpec", "congested_latency", "paper_tiers", "tpu_tiers",
    "LMBSystem", "MemoryHandle", "StaleHandle", "SystemSpec",
    "ExpanderSpec", "HostSpec", "DeviceSpec", "TenantSpec",
    "PrefetchSpec", "ObsSpec", "system_for",
    "Prefetcher", "PrefetchRun", "OverlapScheduler",
    "exposed_latency_s", "hidden_fraction",
    "PlacementPolicy", "PlacementRequest", "ExpanderView",
    "LeastLoadedPolicy", "HeatAwarePolicy", "TenantAffinityPolicy",
    "make_placement_policy",
    "FaultEvent", "FaultPlan", "FaultInjector", "RetryPolicy",
]
