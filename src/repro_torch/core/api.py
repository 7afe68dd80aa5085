"""LMB kernel-module API (paper Table 2).

``LMBHost`` plays the role of the LMB kernel module on one host: it owns a
``BlockAllocator`` fed by the Fabric Manager, exposes the device-class-
agnostic verbs

    alloc(dev, size)               -> Allocation(hpa, mmid[, dpid])
    free(dev, mmid)
    share(dev, mmid, target)       -> Allocation for the target device

which dispatch on the registered device's :class:`DeviceClass` internally
(PCIe → IOMMU mappings + IOVA bus addresses; CXL → SAT entries + HPA bus
addresses + expander DPID for P2P).  The paper's Table-2 names

    lmb_pcie_alloc / lmb_cxl_alloc / lmb_pcie_free / lmb_cxl_free
    lmb_pcie_share / lmb_cxl_share

remain as thin deprecated shims so the paper mapping stays legible; new
code should go through :class:`repro_torch.core.client.LMBSystem`, which wraps
these verbs in typed :class:`~repro_torch.core.client.MemoryHandle` capabilities.

``LMBHost`` maintains the HPA/bus-address ↔ physical mapping plus the
access-control entries (IOMMU/SAT) through the FM, and a per-expander
**generation counter** bumped on every failover — the staleness signal
``MemoryHandle`` capabilities check before acting.  The paper's "loading
priority" concern (LMB must exist before device drivers initialize) maps
to LMBHost being constructed before any consumer in our launchers.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.fabric import (AccessDenied, DeviceClass, DeviceInfo,
                               FabricManager)
from repro_torch.core.metrics import GLOBAL_METRICS, Metrics
from repro_torch.core.pool import (DEFAULT_PAGE_BYTES, BlockAllocator, LMBError,
                             MediaKind, Region)
from repro_torch.obs.trace import SpanTracer

#: HPA window where expander blocks get mapped on the host (arbitrary base
#: chosen above typical host DRAM; purely a modeling constant).
HPA_WINDOW_BASE = 0x4000_0000_0000

#: IOVA window PCIe devices see through their IOMMU domain.  Identity-
#: mapped *within* the window (same block/offset layout as the HPA
#: window) but at a distinct base: a PCIe device's DMA address is an
#: IOMMU translation, not a host physical address, and conflating the
#: two would hide exactly the PCIe-vs-CXL addressing split the paper's
#: Table 2 encodes in its verb names.
PCIE_IOVA_BASE = 0x8000_0000_0000


@dataclasses.dataclass(frozen=True)
class Allocation:
    """What a device driver gets back from an alloc/share call (Table 2)."""

    mmid: int              # unique memory id in the local host
    hpa: int               # host physical address of the region
    bus_addr: int          # device-visible bus address (PCIe) or HPA (CXL)
    nbytes: int
    device_id: str
    #: global PID of the expander, for CXL devices to initiate P2P (Table 2)
    dpid: Optional[int] = None


class LMBHost:
    """The LMB kernel module instance for one host."""

    def __init__(self, fm: FabricManager, host_id: str,
                 page_bytes: int = DEFAULT_PAGE_BYTES,
                 media: MediaKind = MediaKind.DRAM,
                 metrics: Optional[Metrics] = None,
                 expander_dpid: int = 0x7):
        self.fm = fm
        self.host_id = host_id
        self.media = media
        self.metrics = metrics or GLOBAL_METRICS
        self._expander_dpid = expander_dpid
        fm.bind_host(host_id)           # idempotent: no-op if already bound
        self.allocator = BlockAllocator(
            request_block=lambda eid=None, dev=None: fm.request_block(
                host_id, media, expander_id=eid, device_id=dev),
            return_block=lambda bid: fm.return_block(host_id, bid),
            page_bytes=page_bytes)
        # mmid -> set of device_ids with access (owner first)
        self._sharers: Dict[int, list[str]] = {}
        # expander_id -> generation, bumped on every failover touching it;
        # MemoryHandle capabilities record the generation at grant time
        # and refuse to act once it moves (StaleHandle)
        self._generation: Dict[int, int] = {}
        # registered BEFORE any LinkedBuffer (they attach to this host
        # afterwards), so allocator state for a dead expander is gone by
        # the time consumers handle the same failover notification
        fm.on_failover(self._on_failover)

    @property
    def trace(self) -> SpanTracer:
        """The FM's span tracer — hosts and their LinkedBuffers share
        it so fault/burst spans and the link.xfer spans they trigger
        land in one trace with parent links intact."""
        return self.fm.tracer

    def _on_failover(self, expander_id: int) -> None:
        """Drop allocator bookkeeping for the failed expander's blocks —
        the FM re-granted (or lost) them; keeping their free runs around
        would let new allocations land on the dead expander.  Then adopt
        the blank replacement grants, so the capacity the FM preserved
        (and still charges against our quota) is actually allocatable."""
        # invalidate capabilities first: any handle granted on this
        # expander must observe the generation bump before it can race
        # a free/share against the dropped allocator state
        self._generation[expander_id] = self.generation_of(expander_id) + 1
        for mmid in self.allocator.drop_expander(expander_id):
            self._sharers.pop(mmid, None)
        # adopt only replacements on HEALTHY expanders — after a total-pool
        # failure held_grants still lists dead blocks, and re-adopting them
        # would let allocations silently land on dead capacity
        healthy = set(self.fm.healthy_expander_ids())
        for grant in self.fm.held_grants(self.host_id):
            if grant.expander_id in healthy:
                self.allocator.adopt_block(grant)

    # -- HPA mapping -----------------------------------------------------------
    def _hpa_of(self, region: Region) -> int:
        # block_id-indexed window keeps HPAs stable across block reuse
        return (HPA_WINDOW_BASE + region.block_id * (256 * 2**20)
                + region.offset)

    def _bus_addr_of(self, region: Region, device: DeviceInfo) -> int:
        if device.device_class is DeviceClass.PCIE:
            # PCIe devices DMA through the IOMMU: identity-mapped IOVA
            # window at a base distinct from the HPA window
            return (PCIE_IOVA_BASE
                    + (self._hpa_of(region) - HPA_WINDOW_BASE))
        # CXL devices address the expander with the HPA directly (P2P)
        return self._hpa_of(region)

    # -- generations (capability staleness) ------------------------------------
    def generation_of(self, expander_id: int) -> int:
        """Current failover generation of one expander; a MemoryHandle
        minted at generation g is stale once this moves past g."""
        return self._generation.get(expander_id, 0)

    # -- alloc (device-class-agnostic; dispatches on DeviceClass) ---------------
    def alloc(self, device_id: str, nbytes: int,
              expander_id: Optional[int] = None) -> Allocation:
        """Allocate LMB memory for a device (Table-2 alloc, class-agnostic):
        the registered DeviceClass decides IOMMU-vs-SAT authorization and
        the bus-address window, so callers never branch on bus type."""
        device = self.fm.device(device_id)
        region = self.allocator.alloc(device_id, nbytes,
                                      expander_id=expander_id)
        self.fm.authorize(device_id, region.block_id, region.page_start,
                          region.npages)
        self._sharers[region.mmid] = [device_id]
        self.metrics.event(device_id, f"alloc mmid={region.mmid} {nbytes}B")
        return Allocation(
            mmid=region.mmid,
            hpa=self._hpa_of(region),
            bus_addr=self._bus_addr_of(region, device),
            nbytes=region.nbytes,
            device_id=device_id,
            dpid=(self._expander_dpid
                  if device.device_class is DeviceClass.CXL else None))

    def _warn_shim(self, shim: str, repl: str) -> None:
        warnings.warn(
            f"LMBHost.{shim} is a deprecated Table-2 paper-name shim; "
            f"use the class-dispatched LMBHost.{repl} (or the "
            "repro_torch.core.client.LMBSystem capability API)",
            DeprecationWarning, stacklevel=3)

    def lmb_pcie_alloc(self, device_id: str, nbytes: int,
                       expander_id: Optional[int] = None) -> Allocation:
        """Deprecated Table-2 shim: ``alloc`` restricted to PCIe devices."""
        self._warn_shim("lmb_pcie_alloc", "alloc")
        if self.fm.device(device_id).device_class is not DeviceClass.PCIE:
            raise LMBError(f"{device_id} is not a PCIe device")
        return self.alloc(device_id, nbytes, expander_id)

    def lmb_cxl_alloc(self, device_id: str, nbytes: int,
                      expander_id: Optional[int] = None) -> Allocation:
        """Deprecated Table-2 shim: ``alloc`` restricted to CXL devices."""
        self._warn_shim("lmb_cxl_alloc", "alloc")
        if self.fm.device(device_id).device_class is not DeviceClass.CXL:
            raise LMBError(f"{device_id} is not a CXL device")
        return self.alloc(device_id, nbytes, expander_id)

    # -- free (device-class-agnostic) -------------------------------------------
    def free(self, device_id: str, mmid: int) -> None:
        """Free (owner) or drop a mapping of (sharer) an allocation
        (Table-2 free, class-agnostic)."""
        region = self.allocator.region(mmid)
        sharers = self._sharers.get(mmid, [])
        if device_id not in sharers:
            raise AccessDenied(
                f"{device_id} does not hold mmid {mmid}")
        if device_id != region.owner:
            # a sharer "freeing" just drops its mapping
            self.fm.revoke(device_id, region.block_id, region.page_start,
                           region.npages)
            sharers.remove(device_id)
            return
        # owner free: revoke everyone, then release pages
        for dev in sharers:
            self.fm.revoke(dev, region.block_id, region.page_start,
                           region.npages)
        del self._sharers[mmid]
        self.allocator.free(mmid, owner=device_id)
        self.metrics.event(device_id, f"free mmid={mmid}")

    def lmb_pcie_free(self, device_id: str, mmid: int) -> None:
        """Deprecated Table-2 shim for :meth:`free`."""
        self._warn_shim("lmb_pcie_free", "free")
        self.free(device_id, mmid)

    def lmb_cxl_free(self, device_id: str, mmid: int) -> None:
        """Deprecated Table-2 shim for :meth:`free`."""
        self._warn_shim("lmb_cxl_free", "free")
        self.free(device_id, mmid)

    # -- share (device-class-agnostic) ------------------------------------------
    def share(self, src_device: str, mmid: int,
              dst_device: str) -> Allocation:
        """Grant ``dst_device`` zero-copy access to ``src_device``'s
        allocation (Table-2 share, class-agnostic): the destination's
        DeviceClass decides SAT-vs-IOMMU authorization and the returned
        bus address/DPID."""
        region = self.allocator.region(mmid)
        sharers = self._sharers.get(mmid, [])
        if src_device not in sharers:
            raise AccessDenied(
                f"{src_device} cannot share mmid {mmid} it does not hold")
        dst = self.fm.device(dst_device)
        self.fm.authorize(dst_device, region.block_id, region.page_start,
                          region.npages)
        if dst_device not in sharers:
            sharers.append(dst_device)
        self.metrics.event(
            src_device, f"share mmid={mmid} -> {dst_device}")
        return Allocation(
            mmid=mmid,
            hpa=self._hpa_of(region),
            bus_addr=self._bus_addr_of(region, dst),
            nbytes=region.nbytes,
            device_id=dst_device,
            dpid=(self._expander_dpid
                  if dst.device_class is DeviceClass.CXL else None))

    def lmb_pcie_share(self, device_id: str, mmid: int,
                       target_device: str) -> Allocation:
        """Deprecated Table-2 shim for :meth:`share`."""
        self._warn_shim("lmb_pcie_share", "share")
        return self.share(device_id, mmid, target_device)

    def lmb_cxl_share(self, device_id: str, mmid: int,
                      target_device: str) -> Allocation:
        """Deprecated Table-2 shim for :meth:`share`."""
        self._warn_shim("lmb_cxl_share", "share")
        return self.share(device_id, mmid, target_device)

    # -- data-path access check (used by LinkedBuffer + tests) ---------------------
    def check_access(self, device_id: str, mmid: int, page: int = 0) -> None:
        region = self.allocator.region(mmid)
        self.fm.check_access(device_id, region.block_id,
                             region.page_start + page)

    def meter_transfer(self, device_id: str, nbytes: int,
                       mmid: Optional[int] = None,
                       op: str = "demand") -> float:
        """Charge an expander-link transfer to this device's QoS share;
        returns the modeled delay (queue + wire) in seconds.  Every byte a
        consumer moves to/from the LMB tier should pass through here so the
        FM's arbiters see true link occupancy.  ``mmid`` routes the charge
        to the link of the expander actually backing the region; ``op``
        classes the traffic (demand vs prefetch) for the FM's per-class
        accounting."""
        block_id = (self.allocator.region(mmid).block_id
                    if mmid is not None else None)
        return self.fm.meter_transfer(device_id, nbytes,
                                      block_id=block_id, op=op).delay_s

    def meter_transfer_many(
            self, device_id: str,
            charges: Sequence[Tuple[int, Optional[int]]],
            op: str = "demand") -> float:
        """Batched :meth:`meter_transfer`: charge a whole burst in one
        arbitration round-trip per backing link.

        ``charges`` is ``[(nbytes, mmid-or-None), ...]`` — one entry per
        coalesced run the caller already grouped (LinkedBuffer groups by
        chunk).  Runs backed by the SAME expander are merged into a
        single arbiter call carrying their total bytes: fairness
        accounting is byte-denominated, so the schedule and token-bucket
        math are unchanged; only the per-transfer arbitration overhead
        (N calls -> 1 per link) is saved.  ``op`` tags every merged
        charge (the prefetch path passes ``"prefetch"`` so its traffic
        is distinguishable in the FM journal and per-class byte totals).
        Returns the summed modeled delay in seconds."""
        # expander -> [total bytes, representative block_id]
        per_link: Dict[Optional[int], list] = {}
        for nbytes, mmid in charges:
            if nbytes <= 0:
                continue
            block_id = (self.allocator.region(mmid).block_id
                        if mmid is not None else None)
            eid = (self.allocator.expander_of(mmid)
                   if mmid is not None else None)
            acc = per_link.setdefault(eid, [0, block_id])
            acc[0] += nbytes
        delay = 0.0
        for nbytes, block_id in per_link.values():
            delay += self.fm.meter_transfer(device_id, nbytes,
                                            block_id=block_id,
                                            op=op).delay_s
        tr = self.trace
        if tr.enabled and per_link:
            # burst-coalescing telemetry: how many caller runs were
            # merged into how many arbiter round-trips
            tr.event("host.meter.burst", op=op,
                     nbytes=sum(v[0] for v in per_link.values()),
                     runs=len(charges), links=len(per_link),
                     delay_s=delay, device=device_id)
        return delay

    def expander_of(self, mmid: int) -> int:
        """Which pooled expander backs this allocation (placement query)."""
        return self.allocator.expander_of(mmid)

    def owned_bytes(self, device_id: str) -> int:
        return self.allocator.owned_bytes(device_id)
