"""Capability-handle client API: the top of ``repro_torch.core``.

The paper's Table-2 interface is a kernel ABI; this module is the client
surface every consumer in the repo programs against instead of raw
``mmid`` ints and hand-wired ``FabricManager``→``LMBHost`` plumbing.
Following the CXL pooling literature's framing of pooled memory as
*revocable capability grants with policy-driven placement*:

  * :class:`SystemSpec` — one declarative description of the stack
    (expanders, hosts, devices, tenants, placement policy, spare).
  * :class:`LMBSystem` — the session object built from a spec.  It owns
    the fabric/host/arbiter wiring (the ~10 lines previously copied into
    every launcher), has context-manager lifecycle (leaving the ``with``
    block frees every live grant), and mints capabilities.
  * :class:`MemoryHandle` — a typed capability for one allocation,
    carrying ``(host, device, mmid, generation)``.  It offers
    ``.share(dev)``, ``.free()``, ``.expander()`` and ``with``-scoped
    auto-free, and raises :class:`StaleHandle` instead of acting on
    dead memory: use-after-free (including an owner free invalidating
    sharer capabilities, and hot-page migration draining a LinkedBuffer
    chunk whose handle is then freed) and use-after-failover (the
    per-expander generation counters are bumped by the existing
    ``on_failover`` path in :class:`~repro_torch.core.api.LMBHost`).

Raw ``mmid`` ints never cross this surface: a handle is the only way to
name memory, and a dead handle is typed-dead, not silently dangling.

Example::

    spec = SystemSpec(expanders=(ExpanderSpec(gib=8),),
                      hosts=("host0",),
                      devices=(DeviceSpec("ssd0"),
                               DeviceSpec("accel0", DeviceClass.CXL,
                                          spid=0x11)))
    with LMBSystem(spec) as sys:
        with sys.alloc("ssd0", 64 << 20) as h:
            peer = h.share("accel0")        # zero-copy capability
            print(h.expander(), peer.dpid)
        # h (and peer) freed here; quota released
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Union

from repro_torch.core.api import Allocation, LMBHost
from repro_torch.core.fabric import (DEFAULT_LINK_BW_Bps, DeviceClass, DeviceInfo,
                               FabricManager)
from repro_torch.core.metrics import GLOBAL_METRICS, Metrics
from repro_torch.core.placement import (PlacementPolicy, TenantAffinityPolicy,
                                  make_placement_policy)
from repro_torch.core.pool import (DEFAULT_PAGE_BYTES, Expander, LMBError,
                             MediaKind)
from repro_torch.obs.trace import (DEFAULT_RING_CAPACITY, GLOBAL_TRACER, Span,
                             SpanTracer)

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.buffer import LinkedBuffer
    from repro_torch.core.faults import FaultInjector, FaultPlan, RetryPolicy


class StaleHandle(LMBError):
    """The capability no longer refers to live memory: it was freed, its
    owner freed the underlying region, or the backing expander failed
    over / was migrated since the grant (generation mismatch)."""


class MemoryHandle:
    """Typed capability for one LMB allocation.

    Replaces raw ``mmid`` ints at the client surface: the handle knows
    which host and device it belongs to, which expander backs it, and the
    expander's failover generation at grant time.  Every operation checks
    liveness first and raises :class:`StaleHandle` on use-after-free or
    stale-after-failover — the two bugs an integer mmid cannot catch.

    Handles are context managers: ``with system.alloc(...) as h:`` frees
    the grant (releasing host quota) on exit, unless something else
    already invalidated it.
    """

    __slots__ = ("host_id", "device_id", "mmid", "generation",
                 "_host", "_allocation", "_home", "_freed", "_owner",
                 "_sharers", "_session")

    def __init__(self, host: LMBHost, allocation: Allocation,
                 owner: Optional["MemoryHandle"] = None):
        self._host = host
        self._allocation = allocation
        self.host_id = host.host_id
        self.device_id = allocation.device_id
        self.mmid = allocation.mmid
        self._home = host.expander_of(allocation.mmid)
        self.generation = host.generation_of(self._home)
        self._freed = False
        #: the owning handle when this capability came from ``.share``
        self._owner = owner
        #: capabilities derived from this one (owner handles only)
        self._sharers: List["MemoryHandle"] = []
        #: session tracking this handle (LMBSystem), if any
        self._session: Optional["LMBSystem"] = None

    # ------------------------------------------------------------- minting
    @classmethod
    def alloc(cls, host: LMBHost, device_id: str, nbytes: int,
              expander_id: Optional[int] = None) -> "MemoryHandle":
        """Allocate through the class-agnostic Table-2 verb and wrap the
        grant in a capability."""
        return cls(host, host.alloc(device_id, nbytes,
                                    expander_id=expander_id))

    # ----------------------------------------------------------- liveness
    def _ensure_live(self) -> None:
        if self._freed:
            raise StaleHandle(
                f"handle mmid={self.mmid} ({self.device_id}@{self.host_id})"
                " was already freed")
        live_gen = self._host.generation_of(self._home)
        if live_gen != self.generation:
            raise StaleHandle(
                f"handle mmid={self.mmid} ({self.device_id}@{self.host_id})"
                f" is stale: expander {self._home} moved to generation "
                f"{live_gen} (granted at {self.generation}) — failover "
                "invalidated the region")

    @property
    def stale(self) -> bool:
        """True when any operation on this handle would raise
        :class:`StaleHandle` (non-throwing probe)."""
        try:
            self._ensure_live()
        except StaleHandle:
            return True
        return False

    # ----------------------------------------------------- capability ops
    @property
    def nbytes(self) -> int:
        return self._allocation.nbytes

    @property
    def hpa(self) -> int:
        """Host physical address of the region (stable for its lifetime)."""
        self._ensure_live()
        return self._allocation.hpa

    @property
    def bus_addr(self) -> int:
        """Device-visible address: IOVA for PCIe devices, HPA for CXL."""
        self._ensure_live()
        return self._allocation.bus_addr

    @property
    def dpid(self) -> Optional[int]:
        """Expander port id for CXL P2P (None on PCIe handles)."""
        return self._allocation.dpid

    def expander(self) -> int:
        """Which pooled expander backs this grant (placement query)."""
        self._ensure_live()
        return self._home

    def share(self, device_id: str) -> "MemoryHandle":
        """Grant another device zero-copy access; returns the sharer's own
        capability (invalidated with this one when the owner frees).

        One live capability per (allocation, device): sharing to a device
        that already holds one returns the existing handle instead of
        minting an alias — two handles over one underlying mapping would
        let freeing the first leave the second dangling."""
        self._ensure_live()
        root = self._owner if self._owner is not None else self
        if device_id == root.device_id and not root._freed:
            return root
        for s in root._sharers:
            if s.device_id == device_id and not s._freed:
                return s
        alloc = self._host.share(self.device_id, self.mmid, device_id)
        handle = MemoryHandle(self._host, alloc, owner=root)
        root._sharers.append(handle)
        return handle

    def free(self) -> None:
        """Release the capability.  For the owner: frees the region,
        revokes every sharer's access, and invalidates their handles.
        For a sharer: drops only its own mapping."""
        self._ensure_live()
        self._host.free(self.device_id, self.mmid)
        self._freed = True
        if self._owner is None:
            for s in self._sharers:
                s._freed = True
                s._untrack()
            self._sharers.clear()
        else:
            try:
                self._owner._sharers.remove(self)
            except ValueError:
                pass
        self._untrack()

    def _untrack(self) -> None:
        if self._session is not None:
            self._session._discard(self)
            self._session = None

    # ------------------------------------------------------ with-lifetime
    def __enter__(self) -> "MemoryHandle":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if not self.stale:
            self.free()

    def __repr__(self) -> str:
        state = "stale" if self.stale else "live"
        return (f"MemoryHandle(mmid={self.mmid}, device={self.device_id!r},"
                f" host={self.host_id!r}, expander={self._home},"
                f" gen={self.generation}, {self.nbytes}B, {state})")


# --------------------------------------------------------------------------
# Declarative system specification
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ExpanderSpec:
    """One pooled GFD expander."""

    gib: int = 4
    media: MediaKind = MediaKind.DRAM
    #: explicit pool id; defaults to the spec's position
    expander_id: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class HostSpec:
    """One host running an LMB kernel module instance."""

    host_id: str
    quota_bytes: Optional[int] = None
    page_bytes: int = DEFAULT_PAGE_BYTES


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One PCIe/CXL device attached to the fabric."""

    device_id: str
    device_class: DeviceClass = DeviceClass.PCIE
    #: Source PBR id — required for CXL devices
    spid: Optional[int] = None
    bw_weight: float = 1.0
    bw_burst_bytes: int = 0
    tenant: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant sharing the fabric (placement affinity + QoS identity)."""

    name: str
    #: seed the tenant-affinity policy's home expander for this tenant
    preferred_expander: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class PrefetchSpec:
    """Default prefetch/overlap knobs for buffers minted by this system.

    ``depth`` > 0 turns on the burst-native prefetcher for every
    :meth:`LMBSystem.buffer` that does not pass its own
    ``prefetch_depth``; ``overlap`` additionally wires an
    :class:`~repro_torch.core.overlap.OverlapScheduler` over the fabric's link
    so prefetch bursts are admitted only while they fit behind the
    consumer's compute window (deferred otherwise, never dropped).
    """

    #: pages of lookahead per round (0 = prefetch off unless the buffer
    #: opts in itself)
    depth: int = 0
    #: scheduled-backlog cap, as a multiple of ``depth``
    backlog_factor: int = 8
    #: gate prefetch bursts behind the compute window
    overlap: bool = False
    #: initial compute-window estimate (seconds); consumers refine it
    #: via LinkedBuffer.note_compute_window
    compute_window_s: float = 0.0
    #: concurrent DMA streams the overlap budget assumes
    streams: int = 1

    def validate(self) -> None:
        if self.depth < 0:
            raise ValueError("prefetch depth must be >= 0")
        if self.backlog_factor < 1:
            raise ValueError("prefetch backlog_factor must be >= 1")


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """Observability knobs for one system (see ``repro_torch.obs``).

    ``trace=True`` mints a PRIVATE :class:`~repro_torch.obs.trace.SpanTracer`
    for the session and attaches it to the FM, every host, and every
    buffer/overlap-scheduler the session builds — spans from the whole
    data path land in one ring.  ``trace=False`` (the default) leaves
    components on the process-wide ``GLOBAL_TRACER``, which is disabled
    unless a harness (``benchmarks/run.py --trace``) turned it on; the
    disabled path is a single guard check per call site.
    """

    #: record spans into a session-private tracer
    trace: bool = False
    #: ring-buffer span capacity (oldest spans overwritten past this)
    trace_capacity: int = DEFAULT_RING_CAPACITY

    def validate(self) -> None:
        if self.trace_capacity < 1:
            raise ValueError("trace_capacity must be >= 1")


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """Everything needed to stand up one LMB stack, declaratively.

    Convenience coercions: ``expanders`` may be an int (that many default
    expanders) or a sequence of :class:`ExpanderSpec`; ``hosts`` entries
    may be bare host-id strings; ``tenants`` entries may be bare names;
    ``placement`` may be a policy name (``"least-loaded"``,
    ``"heat-aware"``, ``"tenant-affinity"``) or a
    :class:`~repro_torch.core.placement.PlacementPolicy` instance.
    """

    expanders: Union[int, Sequence[ExpanderSpec]] = 1
    hosts: Sequence[Union[HostSpec, str]] = ("host0",)
    devices: Sequence[DeviceSpec] = ()
    tenants: Sequence[Union[TenantSpec, str]] = ()
    placement: Union[str, PlacementPolicy] = "least-loaded"
    #: add a passive standby expander the FM promotes on failure
    spare: bool = False
    link_bandwidth_Bps: float = DEFAULT_LINK_BW_Bps
    #: capacity of each default expander when ``expanders`` is an int
    pool_gib: int = 4
    #: default prefetch/overlap knobs for buffers minted by this system
    prefetch: PrefetchSpec = dataclasses.field(default_factory=PrefetchSpec)
    #: observability (span tracing) knobs for this system
    obs: ObsSpec = dataclasses.field(default_factory=ObsSpec)

    # -- normalized views ---------------------------------------------------
    def expander_specs(self) -> List[ExpanderSpec]:
        if isinstance(self.expanders, int):
            if self.expanders < 1:
                raise ValueError("at least one expander required")
            return [ExpanderSpec(gib=self.pool_gib)
                    for _ in range(self.expanders)]
        return list(self.expanders)

    def host_specs(self) -> List[HostSpec]:
        return [h if isinstance(h, HostSpec) else HostSpec(h)
                for h in self.hosts]

    def tenant_specs(self) -> List[TenantSpec]:
        return [t if isinstance(t, TenantSpec) else TenantSpec(t)
                for t in self.tenants]

    def validate(self) -> None:
        self.prefetch.validate()
        self.obs.validate()
        hosts = self.host_specs()
        if not hosts:
            raise ValueError("SystemSpec needs at least one host")
        ids = [h.host_id for h in hosts]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate host ids: {ids}")
        dev_ids = [d.device_id for d in self.devices]
        if len(set(dev_ids)) != len(dev_ids):
            raise ValueError(f"duplicate device ids: {dev_ids}")
        declared = {t.name for t in self.tenant_specs()}
        for d in self.devices:
            if d.device_class is DeviceClass.CXL and d.spid is None:
                raise ValueError(f"CXL device {d.device_id} needs an SPID")
            if d.tenant is not None and declared and d.tenant not in declared:
                raise ValueError(
                    f"device {d.device_id} names undeclared tenant "
                    f"{d.tenant!r} (declared: {sorted(declared)})")


class LMBSystem:
    """One LMB stack session, built from a :class:`SystemSpec`.

    Owns the ``FabricManager``, every ``LMBHost``, and the per-expander
    link arbiters, wired once here instead of per-entry-point.  All
    allocation flows through :meth:`alloc`, which returns
    :class:`MemoryHandle` capabilities; :meth:`close` (or leaving the
    ``with`` block) frees every live handle so quota cannot leak.
    """

    def __init__(self, spec: SystemSpec,
                 metrics: Optional[Metrics] = None):
        spec.validate()
        self.spec = spec
        exp_specs = spec.expander_specs()
        expanders = [
            Expander([(e.media, e.gib * 2**30)],
                     expander_id=(e.expander_id if e.expander_id is not None
                                  else i))
            for i, e in enumerate(exp_specs)]
        spare = None
        if spec.spare:
            tmpl = exp_specs[0]
            spare = Expander(
                [(tmpl.media, tmpl.gib * 2**30)],
                expander_id=max(e.expander_id for e in expanders) + 1)
        policy = spec.placement
        if isinstance(policy, str):
            kwargs = {}
            if policy == TenantAffinityPolicy.name:
                # seed declared tenant homes before the first placement;
                # a caller-supplied policy INSTANCE is taken as-is (the
                # caller owns its assignments) and never mutated here
                seeds = {t.name: t.preferred_expander
                         for t in spec.tenant_specs()
                         if t.preferred_expander is not None}
                if seeds:
                    kwargs["assignments"] = seeds
            policy = make_placement_policy(policy, **kwargs)
        self.fm = FabricManager(expanders, spare=spare,
                                link_bandwidth_Bps=spec.link_bandwidth_Bps,
                                placement=policy)
        self.placement_policy = policy
        self.metrics = metrics if metrics is not None else GLOBAL_METRICS
        #: the session's span tracer — private when the spec asks for
        #: tracing, else the process-wide (normally disabled) default.
        #: Attached to the FM, whose tracer every host/buffer reads.
        self.tracer: SpanTracer = (
            SpanTracer(capacity=spec.obs.trace_capacity)
            if spec.obs.trace else GLOBAL_TRACER)
        self.fm.tracer = self.tracer
        for d in spec.devices:
            self.fm.register_device(DeviceInfo(
                d.device_id, d.device_class, spid=d.spid,
                bw_weight=d.bw_weight, bw_burst_bytes=d.bw_burst_bytes,
                tenant=d.tenant))
        self._hosts: Dict[str, LMBHost] = {}
        for h in spec.host_specs():
            self.fm.bind_host(h.host_id, h.quota_bytes)
            self._hosts[h.host_id] = LMBHost(
                self.fm, h.host_id, page_bytes=h.page_bytes,
                metrics=metrics)
        # live-handle registry keyed by object id: freed handles drop out
        # (via MemoryHandle._untrack) so a long session does not
        # accumulate every capability it ever minted
        self._handles: Dict[int, MemoryHandle] = {}
        self._buffers: List["LinkedBuffer"] = []
        self._closed = False

    # ------------------------------------------------------------ topology
    def host(self, host_id: Optional[str] = None) -> LMBHost:
        """The named LMBHost — or the only one, when the spec has one."""
        if host_id is None:
            if len(self._hosts) != 1:
                raise ValueError(
                    f"system has {len(self._hosts)} hosts "
                    f"({sorted(self._hosts)}); name one")
            return next(iter(self._hosts.values()))
        host = self._hosts.get(host_id)
        if host is None:
            raise ValueError(f"unknown host {host_id!r} "
                             f"(declared: {sorted(self._hosts)})")
        return host

    @property
    def host_ids(self) -> List[str]:
        return sorted(self._hosts)

    def device(self, device_id: str) -> DeviceInfo:
        return self.fm.device(device_id)

    # --------------------------------------------------------- capabilities
    def alloc(self, device_id: str, nbytes: int, *,
              host_id: Optional[str] = None,
              expander_id: Optional[int] = None) -> MemoryHandle:
        """Allocate LMB memory for a device; returns a capability.  The
        device's registered class picks the PCIe/CXL path internally."""
        self._ensure_open()
        handle = MemoryHandle.alloc(self.host(host_id), device_id, nbytes,
                                    expander_id=expander_id)
        self._track(handle)
        return handle

    def share(self, handle: MemoryHandle,
              device_id: str) -> MemoryHandle:
        """Session-tracked :meth:`MemoryHandle.share`."""
        self._ensure_open()
        shared = handle.share(device_id)
        self._track(shared)
        return shared

    def _track(self, handle: MemoryHandle) -> None:
        handle._session = self
        self._handles[id(handle)] = handle

    def _discard(self, handle: MemoryHandle) -> None:
        self._handles.pop(id(handle), None)

    def free(self, handle: MemoryHandle) -> None:
        handle.free()

    def overlap_scheduler(self, compute_window_s: Optional[float] = None,
                          streams: Optional[int] = None):
        """An :class:`~repro_torch.core.overlap.OverlapScheduler` modeling THIS
        fabric's expander link (CXL added latency at the spec's link
        bandwidth) — the admission gate that decides how much prefetch
        traffic hides behind a compute window.  Defaults come from the
        spec's :class:`PrefetchSpec`."""
        from repro_torch.core.overlap import OverlapScheduler
        from repro_torch.core.tiers import LMB_CXL_ADDED_S, TierKind, TierSpec
        pf = self.spec.prefetch
        tier = TierSpec(TierKind.LMB_CXL, LMB_CXL_ADDED_S,
                        self.spec.link_bandwidth_Bps)
        return OverlapScheduler(
            tier,
            compute_window_s=(pf.compute_window_s if compute_window_s
                              is None else compute_window_s),
            streams=pf.streams if streams is None else streams,
            trace=self.fm.tracer)

    def buffer(self, *, name: str, device_id: str,
               host_id: Optional[str] = None, **kwargs) -> "LinkedBuffer":
        """A LinkedBuffer wired to this system's host (the consumer-facing
        paged-array surface; see repro_torch.core.buffer).  Session-tracked:
        :meth:`close` releases the buffer's LMB footprint too.  The
        spec's :class:`PrefetchSpec` supplies prefetch/overlap defaults
        for buffers that do not pass their own knobs."""
        from repro_torch.core.buffer import LinkedBuffer
        self._ensure_open()
        pf = self.spec.prefetch
        if pf.depth and "prefetch_depth" not in kwargs:
            kwargs["prefetch_depth"] = pf.depth
            kwargs.setdefault("prefetch_backlog_factor", pf.backlog_factor)
        if (pf.overlap and kwargs.get("prefetch_depth")
                and "overlap" not in kwargs):
            kwargs["overlap"] = self.overlap_scheduler()
        buf = LinkedBuffer(name=name, device_id=device_id,
                           host=self.host(host_id), **kwargs)
        self._buffers.append(buf)
        return buf

    # ------------------------------------------------------------ operations
    def set_quota(self, host_id: str, quota_bytes: int) -> None:
        self.fm.set_quota(host_id, quota_bytes)

    def set_bw_share(self, device_id: str, weight: float,
                     burst_bytes: Optional[int] = None) -> None:
        self.fm.set_bw_share(device_id, weight, burst_bytes)

    def inject_failure(self, expander_id: Optional[int] = None) -> None:
        """Kill one expander (failure drill); handles homed on it go
        stale via the generation bump."""
        self.fm.inject_failure(expander_id)

    def readmit_expander(self, expander_id: int) -> None:
        """Repair drill: a failed expander rejoins the pool blank (see
        FabricManager.readmit_expander).  Pre-failure handles stay
        stale; buffers exit degraded mode."""
        self.fm.readmit_expander(expander_id)

    def attach_fault_injector(self, plan: "FaultPlan", *,
                              retry: Optional["RetryPolicy"] = None,
                              seed: int = 0) -> "FaultInjector":
        """Attach the chaos layer (repro_torch.core.faults) to this session's
        fabric: the plan's timed faults fire as the fabric's link clock
        advances, and every metered transfer pays the active fault
        state's modeled cost.  Returns the injector (counters /
        snapshot live on it)."""
        from repro_torch.core.faults import FaultInjector, RetryPolicy
        injector = FaultInjector(plan,
                                 retry=retry if retry is not None
                                 else RetryPolicy(),
                                 seed=seed)
        self.fm.attach_fault_injector(injector)
        return injector

    # ---------------------------------------------------------- introspection
    @property
    def healthy(self) -> bool:
        return self.fm.healthy

    def live_handles(self) -> List[MemoryHandle]:
        return [h for h in self._handles.values() if not h.stale]

    def snapshot(self) -> dict:
        snap = self.fm.snapshot()
        snap["live_handles"] = len(self.live_handles())
        # surface journal growth as registry gauges, so fleet-level
        # telemetry sees it without holding an FM reference
        js = snap["journal"]
        self.metrics.gauge("fm.journal_len", js["len"])
        for opname, n in js["by_op"].items():
            self.metrics.gauge(f"fm.journal.{opname}", n)
        snap["trace"] = self.tracer.snapshot()
        return snap

    # ------------------------------------------------------------- tracing
    def trace_spans(self) -> List[Span]:
        """Spans recorded by this session's tracer (oldest first)."""
        return self.tracer.spans()

    def export_trace(self, path: str) -> None:
        """Write this session's spans as Chrome trace-event JSON."""
        from repro_torch.obs.export import write_chrome_trace
        write_chrome_trace(self.trace_spans(), path,
                           extra={"system": repr(self)})

    # -------------------------------------------------------------- lifecycle
    def _ensure_open(self) -> None:
        if self._closed:
            raise LMBError("LMBSystem session is closed")

    def close(self) -> None:
        """End the session: release every session-created buffer's LMB
        footprint, then free every live capability (sharers before
        owners, so owner frees see consistent sharer lists).  Quota held
        through this session cannot outlive it."""
        if self._closed:
            return
        for buf in self._buffers:
            buf.close()
        self._buffers.clear()
        for handle in sorted(self._handles.values(),
                             key=lambda h: h._owner is None):
            try:
                handle.free()
            except (StaleHandle, LMBError):
                continue       # already dead (failover, owner-free, ...)
        self._handles.clear()
        self._closed = True

    def __enter__(self) -> "LMBSystem":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"LMBSystem(hosts={self.host_ids}, "
                f"expanders={self.fm.expander_ids}, "
                f"placement={self.placement_policy.name!r}, "
                f"{'closed' if self._closed else 'open'})")


def system_for(device_id: str = "dev0", *,
               host_id: str = "host0",
               pool_gib: int = 4,
               page_bytes: int = DEFAULT_PAGE_BYTES,
               n_expanders: int = 1,
               device_class: DeviceClass = DeviceClass.PCIE,
               spid: Optional[int] = None,
               spare: bool = False,
               placement: Union[str, PlacementPolicy] = "least-loaded",
               tenants: Sequence[Union[TenantSpec, str]] = (),
               link_bandwidth_Bps: float = DEFAULT_LINK_BW_Bps,
               metrics: Optional[Metrics] = None,
               obs: Optional[ObsSpec] = None) -> LMBSystem:
    """One-device convenience constructor for the overwhelmingly common
    single-host shape (launchers, benchmarks, tests).  ``tenants``
    declares the QoS/placement identities sharing the stack (bare names
    or :class:`TenantSpec`) and ``link_bandwidth_Bps`` sizes the
    expander links — the two knobs multi-tenant serve sweeps turn."""
    spec = SystemSpec(
        expanders=n_expanders,
        pool_gib=pool_gib,
        hosts=(HostSpec(host_id, page_bytes=page_bytes),),
        devices=(DeviceSpec(device_id, device_class, spid=spid),),
        tenants=tuple(tenants),
        spare=spare,
        placement=placement,
        link_bandwidth_Bps=link_bandwidth_Bps,
        obs=obs if obs is not None else ObsSpec())
    return LMBSystem(spec, metrics=metrics)
