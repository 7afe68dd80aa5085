"""Fabric Manager (FM) and access control (SAT / IOMMU) for LMB.

The FM "controls aspects of the system related to binding and management of
pooled ports and devices" (paper Table 1).  Here it:

  * owns a **pooled set of Expanders** (GFDs) and grants/releases 256 MB
    blocks, tracking which expander backs each block (block→expander
    placement) and arbitrating each expander's link independently,
  * maintains the **SAT** (SPID Access Table) authorizing CXL devices, and
    IOMMU-style per-PCIe-device mapping tables,
  * supports **dynamic capacity**: per-host quotas that can be raised or
    lowered at runtime (CXL DCD semantics),
  * supports **failure injection + recovery** — the paper calls out that "a
    single failure in the memory expander can render all devices unavailable";
    we journal every grant so that consumers can rebuild after fail-over to a
    spare expander (or onto the surviving pooled expanders),
  * keeps an **allocation journal** that makes the pool reconstructible
    (needed by the training checkpoint/restore path); hot-page migrations
    (repro_torch.qos.migration) are journaled the same way DCD capacity events are.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import (TYPE_CHECKING, Callable, Dict, List, Optional, Sequence,
                    Set, Tuple, Union)

if TYPE_CHECKING:  # rack sits above core in the layering; annotation only
    from repro_torch.core.faults import FaultInjector
    from repro_torch.rack.topology import PathCost, RackTopology

from repro_torch.core.placement import (ExpanderView, PlacementPolicy,
                                  PlacementRequest, make_placement_policy)
from repro_torch.core.pool import (BLOCK_BYTES, BlockGrant, Expander,
                             InvalidHandle, LMBError, MediaKind,
                             OutOfMemory)
from repro_torch.obs.trace import GLOBAL_TRACER, SpanTracer
from repro_torch.qos.arbiter import LinkArbiter, TransferGrant

#: default per-expander link bandwidth (matches the LMB_CXL tier's 30 GB/s)
DEFAULT_LINK_BW_Bps = 30e9


class DeviceClass(enum.Enum):
    PCIE = "pcie"   # host-forwarded path; isolation via IOMMU tables
    CXL = "cxl"     # P2P path; isolation via SPID Access Table (SAT)


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    device_id: str
    device_class: DeviceClass
    #: Source PBR ID for CXL devices (paper Table 1); None for PCIe devices
    spid: Optional[int] = None
    #: weighted-fair share of the expander link (repro_torch.qos.arbiter)
    bw_weight: float = 1.0
    #: token-bucket burst allowance on the link; 0 = no burst credit
    bw_burst_bytes: int = 0
    #: tenant this device belongs to — placement policies (e.g.
    #: tenant-affinity) and per-tenant QoS key on it; None = untenanted
    tenant: Optional[str] = None


class AccessDenied(LMBError):
    pass


class SAT:
    """SPID Access Table: (spid → set of block_ids it may touch).

    Matches the paper's GFD access control: "GFD can identify the CXL device
    or host that initiates the request according to the SPID field"; entries
    are updated on alloc/free/share via the GFD Component Management Command
    Set.
    """

    def __init__(self) -> None:
        self._table: Dict[int, Set[int]] = {}

    def add(self, spid: int, block_id: int) -> None:
        self._table.setdefault(spid, set()).add(block_id)

    def remove(self, spid: int, block_id: int) -> None:
        self._table.get(spid, set()).discard(block_id)

    def check(self, spid: int, block_id: int) -> bool:
        return block_id in self._table.get(spid, set())

    def purge_block(self, block_id: int) -> None:
        """Drop every SPID's authorization for a block that no longer
        exists (failover re-grant of a dead expander's block)."""
        for spids in self._table.values():
            spids.discard(block_id)

    def entries(self) -> Dict[int, Set[int]]:
        return {k: set(v) for k, v in self._table.items()}


class IOMMUTable:
    """Per-PCIe-device allowed (block_id, page range) mappings.

    Models the kernel module creating IOMMU page tables for allocated memory
    (paper §3.3).  Granularity is the allocator page.
    """

    def __init__(self) -> None:
        # device_id -> block_id -> set of page indices
        self._maps: Dict[str, Dict[int, Set[int]]] = {}

    def map(self, device_id: str, block_id: int, page_start: int,
            npages: int) -> None:
        pages = self._maps.setdefault(device_id, {}).setdefault(
            block_id, set())
        pages.update(range(page_start, page_start + npages))

    def unmap(self, device_id: str, block_id: int, page_start: int,
              npages: int) -> None:
        pages = self._maps.get(device_id, {}).get(block_id)
        if pages:
            pages.difference_update(range(page_start, page_start + npages))

    def check(self, device_id: str, block_id: int, page: int) -> bool:
        return page in self._maps.get(device_id, {}).get(block_id, set())

    def purge_block(self, block_id: int) -> None:
        """Drop every device's mappings into a block that no longer
        exists (failover re-grant of a dead expander's block)."""
        for blocks in self._maps.values():
            blocks.pop(block_id, None)

    def mapped_pages(self, device_id: str) -> int:
        return sum(len(p) for p in self._maps.get(device_id, {}).values())


@dataclasses.dataclass
class JournalEntry:
    op: str                    # "grant" | "release" | "bind" | "fail" | ...
    host_id: str
    block_id: Optional[int] = None
    detail: str = ""


class FabricManager:
    """FM: binds hosts/devices to pooled expander capacity; single control
    point.

    ``expander`` may be one :class:`Expander` (the paper's single-GFD setup)
    or a sequence of them (pooled multi-expander fabric).  Each expander has
    its own CXL link, arbitrated by its own :class:`LinkArbiter`; block
    grants record which expander backs them so the data path charges the
    right link and hot-page migration can rebalance placement.

    ``topology`` (optional) places the pool behind a switched rack fabric
    (:class:`repro_torch.rack.topology.RackTopology`): every pooled expander must
    be attached in it, each expander's arbiter is sized to ITS port
    bandwidth, placement policies see per-host path latencies and failure
    domains, and :meth:`inject_domain_failure` can take out a whole
    switch/power domain at once.  Without one, behaviour is exactly the
    pre-topology direct-attach model.
    """

    def __init__(self, expander: Union[Expander, Sequence[Expander]],
                 spare: Optional[Expander] = None,
                 link_bandwidth_Bps: float = DEFAULT_LINK_BW_Bps,
                 placement: Union[str, PlacementPolicy, None] = None,
                 topology: Optional["RackTopology"] = None):
        self._lock = threading.RLock()
        #: block→expander placement policy (repro_torch.core.placement);
        #: injected via SystemSpec, defaults to least-loaded
        self._placement: PlacementPolicy = make_placement_policy(placement)
        exps = (list(expander) if isinstance(expander, (list, tuple))
                else [expander])
        if not exps:
            raise ValueError("at least one expander required")
        ids = [e.expander_id for e in exps]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate expander ids: {ids}")
        self.topology = topology
        if topology is not None:
            known = set(topology.expander_ids)
            missing = [i for i in ids if i not in known]
            if missing:
                raise ValueError(
                    f"expanders {missing} not attached in topology")
        self._link_bandwidth_Bps = float(link_bandwidth_Bps)
        self._expanders: Dict[int, Expander] = {
            e.expander_id: e for e in exps}
        self._arbiters: Dict[int, LinkArbiter] = {
            eid: LinkArbiter(self._port_bw(eid)) for eid in self._expanders}
        self._spare = spare
        if spare is not None and spare.expander_id in self._expanders:
            # standby joins the pool on promotion; give it a free id now
            # (refuses if the spare already granted blocks)
            spare.renumber(max(self._expanders) + 1)
        self._hosts: Dict[str, int] = {}       # host_id -> quota bytes
        self._devices: Dict[str, DeviceInfo] = {}
        self._granted: Dict[str, List[BlockGrant]] = {}
        self._block_home: Dict[int, int] = {}  # block_id -> expander_id
        self.sat = SAT()
        self.iommu = IOMMUTable()
        self.journal: List[JournalEntry] = []
        self._failover_listeners: List[Callable[[int], None]] = []
        self._repair_listeners: List[Callable[[int], None]] = []
        #: chaos layer (repro_torch.core.faults), attached via
        #: attach_fault_injector; None = no fault perturbation at all
        self.fault_injector: Optional["FaultInjector"] = None
        #: bytes metered per traffic class ("demand" | "prefetch" | ...):
        #: lets consumers prove prefetch traffic is tagged and bounded
        self._op_bytes: Dict[str, int] = {}
        #: span tracer — every metered transfer emits one "link.xfer"
        #: span here (the single point where op class, expander, tenant
        #: and the modeled link delay are all known), which is what
        #: makes trace-derived byte totals reconcile with op_bytes().
        #: Defaults to the (disabled) global tracer; LMBSystem swaps in
        #: a private one when SystemSpec.obs.trace is set.
        self.tracer: SpanTracer = GLOBAL_TRACER

    # -- expander set --------------------------------------------------------
    def _port_bw(self, expander_id: int) -> float:
        """An expander's link bandwidth: its topology port when racked,
        else the uniform fabric default (also spares promoted from
        outside the topology)."""
        if self.topology is not None:
            try:
                return self.topology.port_bandwidth_Bps(expander_id)
            except Exception:
                pass
        return self._link_bandwidth_Bps

    def path_cost(self, host_id: str, expander_id: int) -> "PathCost":
        """Fabric cost of ``host_id`` reaching ``expander_id``.  Without
        a topology (or for hosts/expanders outside it) this is the
        direct-attach degenerate cost: 1 hop, zero latency, the
        expander's link bandwidth."""
        from repro_torch.rack.topology import PathCost, TopologyError
        if self.topology is not None:
            try:
                return self.topology.path(host_id, expander_id)
            except TopologyError:
                pass
        return PathCost(hops=1, latency_s=0.0,
                        bandwidth_Bps=self._port_bw(expander_id))

    def domain_of(self, expander_id: int) -> Optional[str]:
        """The expander's correlated failure domain, None when no
        topology is configured (direct attach has no shared domains)."""
        if self.topology is None:
            return None
        try:
            return self.topology.domain_of(expander_id)
        except Exception:
            return None

    @property
    def expander_ids(self) -> List[int]:
        return list(self._expanders)

    @property
    def arbiter(self) -> LinkArbiter:
        """The first HEALTHY expander's link arbiter (single-expander
        back-compat; also the metering fallback when a transfer can't be
        attributed to a block) — a dead expander's frozen arbiter would
        swallow traffic invisibly."""
        healthy = self._healthy_expanders()
        eid = (healthy[0].expander_id if healthy
               else next(iter(self._expanders)))
        return self._arbiters[eid]

    def _healthy_expanders(self) -> List[Expander]:
        return [e for e in self._expanders.values() if not e.failed]

    def expander_of(self, block_id: int) -> int:
        eid = self._block_home.get(block_id)
        if eid is None:
            raise InvalidHandle(f"block {block_id} has no home expander")
        return eid

    def _views(self, media: MediaKind,
               exclude: Sequence[int] = (),
               require_room: bool = True,
               host_id: Optional[str] = None) -> List[ExpanderView]:
        """Candidate expanders as the placement policy sees them: healthy,
        not excluded, and (unless ``require_room`` is off) with at least
        one free block of ``media``.  With a topology, each view carries
        the requesting host's path latency (0.0 for hosts outside the
        topology) and the expander's failure domain, which is what makes
        the pool-aware policy prefer near capacity.  With a fault
        injector attached, browned-out/retraining expanders report a
        saturated link so placement (and migration targets, which
        delegate here) avoid them for the window."""
        inj = self.fault_injector
        return [ExpanderView(
                    expander_id=e.expander_id,
                    free_bytes=e.free_bytes(media),
                    utilization=(
                        self._arbiters[e.expander_id].utilization()
                        if inj is None else inj.degrade_view(
                            e.expander_id,
                            self._arbiters[e.expander_id].utilization())),
                    path_latency_s=(
                        self.path_cost(host_id, e.expander_id).latency_s
                        if host_id is not None and self.topology is not None
                        else 0.0),
                    domain=self.domain_of(e.expander_id))
                for e in self._healthy_expanders()
                if e.expander_id not in exclude
                and (not require_room
                     or e.free_bytes(media) >= BLOCK_BYTES)]

    def _request_for(self, media: MediaKind, host_id: Optional[str] = None,
                     device_id: Optional[str] = None) -> PlacementRequest:
        info = self._devices.get(device_id) if device_id else None
        return PlacementRequest(media=media, host_id=host_id,
                                device_id=device_id,
                                tenant=info.tenant if info else None)

    def _pick_expander(self, media: MediaKind,
                       expander_id: Optional[int] = None,
                       host_id: Optional[str] = None,
                       device_id: Optional[str] = None) -> Expander:
        """Block placement: requested expander, else whatever the injected
        placement policy picks from the healthy-with-room candidates."""
        if expander_id is not None:
            exp = self._expanders.get(expander_id)
            if exp is None:
                raise InvalidHandle(f"unknown expander {expander_id}")
            if exp.failed:
                raise LMBError(f"expander {expander_id} failed")
            return exp
        healthy = self._healthy_expanders()
        if not healthy:
            raise LMBError("no healthy expander in the pool")
        eid = self._placement.choose(
            self._request_for(media, host_id, device_id),
            self._views(media, host_id=host_id))
        exp = self._expanders.get(eid) if eid is not None else None
        if exp is None or exp.failed:
            return healthy[0]               # let grant_block raise OOM
        return exp

    # -- binding -------------------------------------------------------------
    def bind_host(self, host_id: str, quota_bytes: Optional[int] = None) -> None:
        """Bind a host (idempotent).  Re-binding an already-bound host is
        a no-op unless an explicit quota is given, in which case it acts
        like :meth:`set_quota` — it never silently resets a configured
        quota back to the pool total."""
        with self._lock:
            if host_id in self._hosts:
                if (quota_bytes is not None
                        and quota_bytes != self._hosts[host_id]):
                    self.set_quota(host_id, quota_bytes)
                return
            quota = (quota_bytes if quota_bytes is not None
                     else self.total_bytes)
            self._hosts[host_id] = quota
            self._granted.setdefault(host_id, [])
            self.journal.append(JournalEntry("bind", host_id))

    @property
    def total_bytes(self) -> int:
        return sum(e.total_bytes for e in self._expanders.values())

    def set_quota(self, host_id: str, quota_bytes: int) -> None:
        """Dynamic capacity (DCD): change a host's allowance at runtime."""
        with self._lock:
            if host_id not in self._hosts:
                raise InvalidHandle(f"host {host_id} not bound")
            self._hosts[host_id] = quota_bytes
            self.journal.append(
                JournalEntry("quota", host_id, detail=str(quota_bytes)))

    def register_device(self, info: DeviceInfo) -> None:
        with self._lock:
            if info.device_class is DeviceClass.CXL and info.spid is None:
                raise ValueError("CXL device needs an SPID")
            self._devices[info.device_id] = info
            for arb in self._arbiters.values():
                arb.register(info.device_id, weight=info.bw_weight,
                             burst_bytes=info.bw_burst_bytes)

    def device(self, device_id: str) -> DeviceInfo:
        info = self._devices.get(device_id)
        if info is None:
            raise InvalidHandle(f"device {device_id} not registered")
        return info

    # -- block grant/release (called by host BlockAllocators) ----------------
    def request_block(self, host_id: str,
                      media: MediaKind = MediaKind.DRAM,
                      expander_id: Optional[int] = None,
                      device_id: Optional[str] = None) -> BlockGrant:
        with self._lock:
            if host_id not in self._hosts:
                raise InvalidHandle(f"host {host_id} not bound")
            held = len(self._granted[host_id]) * BLOCK_BYTES
            if held + BLOCK_BYTES > self._hosts[host_id]:
                raise OutOfMemory(
                    f"host {host_id} quota exceeded "
                    f"({held + BLOCK_BYTES} > {self._hosts[host_id]})")
            exp = self._pick_expander(media, expander_id,
                                      host_id=host_id, device_id=device_id)
            grant = exp.grant_block(host_id, media)
            self._granted[host_id].append(grant)
            self._block_home[grant.block_id] = exp.expander_id
            self.journal.append(
                JournalEntry("grant", host_id, grant.block_id,
                             detail=f"expander={exp.expander_id}"))
            return grant

    def return_block(self, host_id: str, block_id: int) -> None:
        with self._lock:
            grants = self._granted.get(host_id, [])
            for i, g in enumerate(grants):
                if g.block_id == block_id:
                    grants.pop(i)
                    eid = self._block_home.pop(block_id, None)
                    exp = self._expanders.get(eid)
                    if exp is not None and not exp.failed:
                        exp.release_block(block_id)
                    self.journal.append(
                        JournalEntry("release", host_id, block_id))
                    return
            raise InvalidHandle(
                f"host {host_id} does not hold block {block_id}")

    def held_bytes(self, host_id: str) -> int:
        with self._lock:
            return len(self._granted.get(host_id, [])) * BLOCK_BYTES

    def held_grants(self, host_id: str) -> List[BlockGrant]:
        """The host's live block grants (failover replacements included) —
        lets a host allocator reconcile after a re-grant."""
        with self._lock:
            return list(self._granted.get(host_id, []))

    def healthy_expander_ids(self) -> List[int]:
        return [e.expander_id for e in self._healthy_expanders()]

    # -- bandwidth quotas (the DCD analogue for the shared links) -------------
    def set_bw_share(self, device_id: str, weight: float,
                     burst_bytes: Optional[int] = None) -> None:
        """Grant/revoke link-bandwidth share at runtime, like set_quota does
        for capacity.  Weight is relative (weighted-fair), so 'revoking'
        is lowering a weight — the links themselves are never left idle.
        Applied to every expander's arbiter in the pool."""
        with self._lock:
            info = self.device(device_id)
            self._devices[device_id] = dataclasses.replace(
                info, bw_weight=weight,
                bw_burst_bytes=(info.bw_burst_bytes if burst_bytes is None
                                else burst_bytes))
            for arb in self._arbiters.values():
                arb.register(
                    device_id, weight=weight,
                    burst_bytes=self._devices[device_id].bw_burst_bytes)
            self.journal.append(
                JournalEntry("bw_share", device_id, detail=str(weight)))

    def meter_transfer(self, device_id: str, nbytes: int,
                       block_id: Optional[int] = None,
                       op: str = "demand") -> TransferGrant:
        """Charge a data-path transfer against the device's link share on
        the expander backing ``block_id`` (first expander when unknown).

        ``op`` classes the traffic ("demand" faults/evictions vs
        "prefetch" bursts); per-class byte totals are kept in
        :meth:`op_bytes`.  Hot path (every LinkedBuffer demote/fault):
        deliberately not journaled — aggregate occupancy lives in the
        arbiter snapshots — but non-demand classes (prefetch, already-
        coalesced bursts at scheduler cadence) ARE journaled, like
        migration traffic."""
        info = self.device(device_id)  # InvalidHandle on unknown devices
        with self._lock:
            self._op_bytes[op] = self._op_bytes.get(op, 0) + nbytes
            if op != "demand":
                self.journal.append(JournalEntry(
                    op, device_id, block_id=block_id, detail=f"{nbytes}B"))
        eid = (self._block_home.get(block_id)
               if block_id is not None else None)
        if eid is None or eid not in self._arbiters:
            healthy = self._healthy_expanders()
            eid = (healthy[0].expander_id if healthy
                   else next(iter(self._expanders)))
        grant = self._arbiters[eid].meter(device_id, nbytes)
        inj = self.fault_injector
        if inj is not None:
            # chaos layer: active faults on this link add modeled delay
            # (retry backoff + CRC cost + retransmission wire time,
            # brownout inflation, retrain wait); retransmitted bytes
            # accrue under the "retry" op class so the injector's
            # counters reconcile with op_bytes()
            extra_s, retry_bytes = inj.on_transfer(
                device_id, eid, nbytes, op, grant.delay_s,
                charge=lambda n: self._arbiters[eid].meter(
                    device_id, n).delay_s)
            if retry_bytes:
                with self._lock:
                    self._op_bytes["retry"] = (
                        self._op_bytes.get("retry", 0) + retry_bytes)
            if extra_s > 0.0:
                grant = dataclasses.replace(
                    grant, delay_s=grant.delay_s + extra_s,
                    completion_s=grant.completion_s + extra_s)
        tr = self.tracer
        if tr.enabled:
            # dur is the MODELED link delay (virtual seconds), so span
            # sums over a trace equal the fabric's wait counters
            dom = self.domain_of(eid)
            extra = {"domain": dom} if dom is not None else {}
            extra["clock"] = "modeled"
            tr.add("link.xfer", tr.now(), grant.delay_s, op=op,
                   tenant=info.tenant, expander=eid, nbytes=nbytes,
                   device=device_id, **extra)
        return grant

    def op_bytes(self) -> Dict[str, int]:
        """Metered bytes per traffic class (e.g. demand vs prefetch)."""
        with self._lock:
            return dict(self._op_bytes)

    def advance_links(self, dt_s: float) -> None:
        """Let ``dt_s`` of virtual time pass on every expander link with
        no new traffic — compute running while the wire drains.  The
        overlap benchmarks/tests call this between metered steps so a
        prefetch burst issued during one compute window has actually
        left the wire by the next (otherwise every transfer since t=0
        queues behind its predecessors and modeled delays grow without
        bound).  Doubles as the chaos layer's clock: an attached fault
        injector advances with the links and fires its due events here
        (outside the lock — event handlers re-enter FM methods and
        notify consumer callbacks)."""
        with self._lock:
            for arb in self._arbiters.values():
                arb.advance(dt_s)
        if self.fault_injector is not None:
            self.fault_injector.advance(dt_s)

    def attach_fault_injector(self, injector: "FaultInjector") -> None:
        """Attach the chaos layer (repro_torch.core.faults): the injector
        advances with :meth:`advance_links` and perturbs every
        :meth:`meter_transfer` per its FaultPlan.  One injector per
        fabric; attaching a second replaces the first."""
        injector.bind(self)
        self.fault_injector = injector

    def meter_calls(self) -> int:
        """Total arbitration round-trips across every expander's link —
        the overhead metric the batched data path minimizes (bytes move
        in coalesced bursts, so call count grows with batches, not
        pages).  Counts frozen (failed) arbiters too: their historical
        calls happened."""
        return sum(arb.meter_calls for arb in self._arbiters.values())

    def link_utilization(self, expander_id: Optional[int] = None) -> float:
        """One expander's EWMA link utilization, or the pool-wide max
        (the pressure signal consumers degrade on).  Failed expanders'
        frozen arbiters are excluded from the pool-wide view."""
        if expander_id is not None:
            return self._arbiters[expander_id].utilization()
        utils = self.link_utilizations()
        if not utils:
            return 0.0
        return max(utils.values())

    def link_utilizations(self) -> Dict[int, float]:
        """Per-expander EWMA link utilization (healthy expanders only)."""
        return {e.expander_id: self._arbiters[e.expander_id].utilization()
                for e in self._healthy_expanders()}

    def least_loaded_expander(
            self, exclude: Sequence[int] = (),
            media: MediaKind = MediaKind.DRAM) -> Optional[int]:
        """Migration target: delegated to the SAME placement policy block
        placement uses, so the two cannot drift.  When no expander has a
        whole free block, falls back to candidates without room — the
        migration may fit a consumer's EXISTING free slots there, and
        migrate_pages stops cleanly if growth is refused.  None only when
        the pool offers no alternative expander at all."""
        views = self._views(media, exclude)
        if not views:
            views = self._views(media, exclude, require_room=False)
        return self._placement.choose(self._request_for(media), views)

    def record_migration(self, device_id: str, src_expander: int,
                         dst_expander: int, npages: int,
                         nbytes: int) -> None:
        """Journal a hot-page migration like a DCD capacity event."""
        with self._lock:
            self.journal.append(JournalEntry(
                "migrate", device_id,
                detail=(f"{src_expander}->{dst_expander} "
                        f"pages={npages} bytes={nbytes}")))

    # -- access control -------------------------------------------------------
    def authorize(self, device_id: str, block_id: int, page_start: int,
                  npages: int) -> None:
        info = self.device(device_id)
        if info.device_class is DeviceClass.CXL:
            self.sat.add(info.spid, block_id)
        else:
            self.iommu.map(device_id, block_id, page_start, npages)

    def revoke(self, device_id: str, block_id: int, page_start: int,
               npages: int) -> None:
        info = self.device(device_id)
        if info.device_class is DeviceClass.CXL:
            # SAT is block-granular; only drop when device holds nothing else
            self.sat.remove(info.spid, block_id)
        else:
            self.iommu.unmap(device_id, block_id, page_start, npages)

    def check_access(self, device_id: str, block_id: int, page: int) -> None:
        info = self.device(device_id)
        if info.device_class is DeviceClass.CXL:
            ok = self.sat.check(info.spid, block_id)
        else:
            ok = self.iommu.check(device_id, block_id, page)
        if not ok:
            raise AccessDenied(
                f"{device_id} may not access block {block_id} page {page}")

    # -- failure handling -----------------------------------------------------
    def on_failover(self, cb: Callable[[int], None]) -> None:
        """Register a consumer callback invoked with the failed expander's
        id after its blocks have been re-granted elsewhere."""
        self._failover_listeners.append(cb)

    def off_failover(self, cb: Callable[[int], None]) -> None:
        """Deregister a failover callback (consumer teardown, e.g.
        LinkedBuffer.close) — keeps churned consumers from accumulating
        on the FM for its lifetime.  Unknown callbacks are a no-op."""
        try:
            self._failover_listeners.remove(cb)
        except ValueError:
            pass

    def _promote_spare(self) -> Expander:
        """Standby joins the pool: fresh arbiter seeded with every device's
        CURRENT bandwidth share (weights + burst replayed, like the
        capacity re-grants) so QoS state survives failover too."""
        spare = self._spare
        self._spare = None
        self._expanders[spare.expander_id] = spare
        arb = LinkArbiter(self._port_bw(spare.expander_id))
        self._arbiters[spare.expander_id] = arb
        self.journal.append(JournalEntry(
            "promote", "*", detail=f"expander={spare.expander_id}"))
        for info in self._devices.values():
            arb.register(info.device_id, weight=info.bw_weight,
                         burst_bytes=info.bw_burst_bytes)
            self.journal.append(JournalEntry(
                "bw_share", info.device_id,
                detail=f"{info.bw_weight} (failover replay)"))
        return spare

    def _fail_locked(self, eids: Sequence[int],
                     domain: Optional[str] = None) -> None:
        """Fail every expander in ``eids``, then run ONE re-grant pass.

        Marking them ALL dead before re-granting is what makes
        correlated (domain-wide) failures correct: a per-expander loop
        would re-grant the first casualty's blocks onto siblings that
        are about to die with the same switch/power domain, losing them
        twice.  Caller holds the lock and notifies listeners after."""
        doomed = set()
        for eid in eids:
            exp = self._expanders.get(eid)
            if exp is None:
                raise InvalidHandle(f"unknown expander {eid}")
            doomed.add(eid)
        for eid in doomed:
            self._expanders[eid].failed = True
            detail = f"expander={eid}" + (
                f" domain={domain}" if domain is not None else "")
            self.journal.append(JournalEntry("fail", "*", detail=detail))
        if self._spare is not None:
            self._promote_spare()
        if not self._healthy_expanders():
            # nowhere to re-grant — consumers still hear about the
            # failure (listener callbacks) and enter degraded mode
            return
        for host_id, grants in self._granted.items():
            regrants = []
            for g in grants:
                if self._block_home.get(g.block_id) not in doomed:
                    regrants.append(g)    # homed elsewhere: untouched
                    continue
                # the old block id ceases to exist either way: stale
                # SAT/IOMMU authorizations for it must not outlive it
                self.sat.purge_block(g.block_id)
                self.iommu.purge_block(g.block_id)
                try:
                    texp = self._pick_expander(g.media)
                    ng = texp.grant_block(host_id, g.media)
                except (OutOfMemory, LMBError):
                    self._block_home.pop(g.block_id, None)
                    self.journal.append(
                        JournalEntry("lost", host_id, g.block_id))
                    continue
                self._block_home.pop(g.block_id, None)
                self._block_home[ng.block_id] = texp.expander_id
                regrants.append(ng)
                self.journal.append(
                    JournalEntry("regrant", host_id, ng.block_id,
                                 detail=f"was {g.block_id} now "
                                        f"expander={texp.expander_id}"))
            self._granted[host_id] = regrants

    def inject_failure(self, expander_id: Optional[int] = None) -> None:
        """One expander dies.  With somewhere to go (a passive spare, or
        surviving pooled expanders): re-grant every block homed on the dead
        expander and notify consumers (they must re-populate contents —
        data loss is the consumer's recovery problem, availability is ours).
        With nowhere to go: subsequent requests raise, consumers degrade to
        onboard-only mode (see LinkedBuffer.degraded).

        Idempotent and safe: injecting an already-failed expander is a
        journaled no-op (``fail.noop``) — running ``_fail_locked`` again
        would re-journal the death and re-notify listeners against
        already-purged grant state.  Injecting with no healthy expander
        left (and no explicit target) raises instead of silently
        re-killing a corpse."""
        with self._lock:
            if expander_id is not None:
                exp = self._expanders.get(expander_id)
                if exp is None:
                    raise InvalidHandle(f"unknown expander {expander_id}")
                if exp.failed:
                    self.journal.append(JournalEntry(
                        "fail.noop", "*",
                        detail=f"expander={expander_id} already failed"))
                    return
                eid = expander_id
            else:
                healthy = self._healthy_expanders()
                if not healthy:
                    raise LMBError(
                        "no healthy expander left to fail (pool is "
                        "already empty; name a target explicitly for a "
                        "journaled no-op)")
                eid = healthy[0].expander_id
            self._fail_locked([eid])
        for cb in self._failover_listeners:
            cb(eid)

    def inject_domain_failure(self, domain: str) -> List[int]:
        """Correlated failure: a switch/power domain dies, taking every
        pooled expander behind it at once (paper: "a single failure in
        the memory expander can render all devices unavailable" — a rack
        makes that plural).  Requires a topology; returns the failed
        expander ids.  Re-grants land only on expanders OUTSIDE the dead
        domain (plus a promoted spare, if any)."""
        if self.topology is None:
            raise LMBError("no topology: failure domains undefined")
        eids = [e for e in self.topology.expanders_in_domain(domain)
                if e in self._expanders]
        if not eids:
            raise InvalidHandle(
                f"no pooled expander in failure domain {domain!r}")
        with self._lock:
            self._fail_locked(eids, domain=domain)
        for cb in self._failover_listeners:
            for eid in eids:
                cb(eid)
        return eids

    # -- repair / re-admission -------------------------------------------------
    def on_repair(self, cb: Callable[[int], None]) -> None:
        """Register a consumer callback invoked with the repaired
        expander's id after it rejoins the pool (blank)."""
        self._repair_listeners.append(cb)

    def off_repair(self, cb: Callable[[int], None]) -> None:
        """Deregister a repair callback (consumer teardown); unknown
        callbacks are a no-op."""
        try:
            self._repair_listeners.remove(cb)
        except ValueError:
            pass

    def readmit_expander(self, expander_id: int) -> None:
        """Repair: a failed expander rejoins the pool BLANK (the FRU was
        replaced) — before this, a dead expander was dead forever.

        The expander's grant state is reset (old block ids never return;
        the id namespace keeps advancing, so stale capabilities cannot
        collide with post-repair grants), its arbiter is rebuilt fresh
        with every device's CURRENT bandwidth share replayed (exactly as
        spare promotion does), and any grants still homed on it — the
        total-pool-failure case, where ``_fail_locked`` had nowhere to
        re-grant — are journaled ``lost`` and purged from the SAT/IOMMU
        tables.  Consumers hear about it via :meth:`on_repair` (e.g.
        ``LinkedBuffer`` exits degraded mode); host-side generation
        counters are NOT rolled back, so handles that went stale at
        failure stay stale after repair."""
        with self._lock:
            exp = self._expanders.get(expander_id)
            if exp is None:
                raise InvalidHandle(f"unknown expander {expander_id}")
            if not exp.failed:
                raise LMBError(
                    f"expander {expander_id} is not failed; nothing to "
                    "readmit")
            # grants that were never re-granted elsewhere (total-pool
            # failure) are gone for good: the repaired expander is blank
            for host_id, grants in self._granted.items():
                kept = []
                for g in grants:
                    if self._block_home.get(g.block_id) != expander_id:
                        kept.append(g)
                        continue
                    self._block_home.pop(g.block_id, None)
                    self.sat.purge_block(g.block_id)
                    self.iommu.purge_block(g.block_id)
                    self.journal.append(JournalEntry(
                        "lost", host_id, g.block_id,
                        detail="discovered at repair"))
                self._granted[host_id] = kept
            exp.reset()
            exp.failed = False
            arb = LinkArbiter(self._port_bw(expander_id))
            self._arbiters[expander_id] = arb
            for info in self._devices.values():
                arb.register(info.device_id, weight=info.bw_weight,
                             burst_bytes=info.bw_burst_bytes)
            self.journal.append(JournalEntry(
                "repair", "*", detail=f"expander={expander_id}"))
        tr = self.tracer
        if tr.enabled:
            tr.event("fault.repair.admitted", op="fault",
                     expander=expander_id)
        for cb in self._repair_listeners:
            cb(expander_id)

    @property
    def healthy(self) -> bool:
        return bool(self._healthy_expanders()) or self._spare is not None

    # -- journal telemetry / compaction ---------------------------------------
    def journal_stats(self) -> Dict[str, object]:
        """Journal growth telemetry: length + per-op-class counts."""
        with self._lock:
            by_op: Dict[str, int] = {}
            for e in self.journal:
                by_op[e.op] = by_op.get(e.op, 0) + 1
            return {"len": len(self.journal), "by_op": by_op}

    def compact(self) -> int:
        """Fold superseded grant/release pairs out of the journal.

        A ``grant`` (or failover ``regrant``) whose block was later
        ``release``d by the same host carries no live state — replaying
        the journal yields the same held-block set without the pair.
        Only exactly-matched pairs are removed (most recent pending
        grant per (host, block)); every other entry class (bind, quota,
        bw_share, fail, promote, lost, migrate, prefetch bursts, ...)
        is preserved verbatim and in order.  Returns the number of
        entries removed.
        """
        with self._lock:
            pending: Dict[Tuple[str, Optional[int]], List[int]] = {}
            dead: Set[int] = set()
            for i, e in enumerate(self.journal):
                key = (e.host_id, e.block_id)
                if e.op in ("grant", "regrant"):
                    pending.setdefault(key, []).append(i)
                elif e.op == "release":
                    stack = pending.get(key)
                    if stack:
                        dead.add(stack.pop())
                        dead.add(i)
            if not dead:
                return 0
            self.journal = [e for i, e in enumerate(self.journal)
                            if i not in dead]
            return len(dead)

    # -- introspection --------------------------------------------------------
    def placement(self) -> Dict[int, int]:
        """blocks held per expander (the block→expander placement map)."""
        out = {eid: 0 for eid in self._expanders}
        for eid in self._block_home.values():
            out[eid] = out.get(eid, 0) + 1
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "hosts": dict(self._hosts),
                "held_blocks": {h: [g.block_id for g in gs]
                                for h, gs in self._granted.items()},
                "free_bytes": sum(e.free_bytes()
                                  for e in self._healthy_expanders()),
                "journal_len": len(self.journal),
                "journal": self.journal_stats(),
                "healthy": self.healthy,
                "placement_policy": self._placement.name,
                "link": self.arbiter.snapshot(),
                "placement": self.placement(),
                "topology": (self.topology.snapshot()
                             if self.topology is not None else None),
                "faults": (self.fault_injector.snapshot()
                           if self.fault_injector is not None else None),
                "expanders": {
                    eid: {
                        "failed": e.failed,
                        "free_bytes": e.free_bytes(),
                        "utilization": self._arbiters[eid].utilization(),
                        "link": self._arbiters[eid].snapshot(),
                        "domain": self.domain_of(eid),
                    }
                    for eid, e in self._expanders.items()
                },
            }


def make_default_fabric(pool_gib: int = 64,
                        spare: bool = False,
                        link_bandwidth_Bps: float = DEFAULT_LINK_BW_Bps,
                        ) -> Tuple[FabricManager, Expander]:
    """One DRAM expander of ``pool_gib`` (+ optional passive spare), one FM."""
    exp = Expander([(MediaKind.DRAM, pool_gib * 2**30)], expander_id=0)
    sp = (Expander([(MediaKind.DRAM, pool_gib * 2**30)], expander_id=1)
          if spare else None)
    return FabricManager(exp, spare=sp,
                         link_bandwidth_Bps=link_bandwidth_Bps), exp


def make_multi_fabric(n_expanders: int = 2,
                      pool_gib: int = 64,
                      link_bandwidth_Bps: float = DEFAULT_LINK_BW_Bps,
                      spare: bool = False,
                      topology: Optional["RackTopology"] = None,
                      placement: Union[str, PlacementPolicy, None] = None,
                      ) -> Tuple[FabricManager, List[Expander]]:
    """Pooled fabric: ``n_expanders`` DRAM expanders of ``pool_gib`` each,
    one FM arbitrating each expander's link independently.  ``topology``
    racks the pool behind a switched fabric (expander ids 0..n-1 must be
    attached in it)."""
    exps = [Expander([(MediaKind.DRAM, pool_gib * 2**30)], expander_id=i)
            for i in range(n_expanders)]
    sp = (Expander([(MediaKind.DRAM, pool_gib * 2**30)],
                   expander_id=n_expanders) if spare else None)
    fm = FabricManager(exps, spare=sp,
                       link_bandwidth_Bps=link_bandwidth_Bps,
                       placement=placement, topology=topology)
    return fm, exps
