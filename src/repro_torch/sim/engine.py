"""Discrete-event engine: closed-loop QD simulation of the SSD pipeline.

A fixed queue-depth worker pool (fio/libaio semantics, QD=64) keeps ``qd``
IOs in flight.  Each IO serializes through up to two rate-limited stages:

  index stage — only for external (non-onboard) lookups; throughput-limited
      by the device's IndexEngine at the scheme's tier latency, and adds the
      tier latency to the IO's completion time;
  data stage  — throughput-limited by the device's baseline Table-3 numbers,
      and adds the baseline per-IO latency.

Event structure: because both stages are work-conserving single-queue rate
limiters, the DES reduces to tracking each stage's next-free time while still
processing every IO individually (so we get exact per-IO latencies and can
mix hit/miss populations from the locality model).

As of the rack-scale PR the default execution engine is the VECTORIZED
struct-of-arrays core (``repro_torch.rack.des.simulate_lanes``): the same
recurrence, evaluated as chunked max-plus prefix scans over numpy
arrays, with many devices advancing in lockstep lanes.  ``simulate``,
``simulate_shared_fabric`` and ``simulate_multi_expander`` are all
re-expressed on that core; the original per-IO Python loop survives as
``engine="scalar"`` — the reference implementation regression tests and
the rack_sweep speedup gate compare against.

Multi-device mode (``simulate_shared_fabric``): N devices hammer ONE
expander through a shared link — the scalability question the paper's Fig 6
never answers.  The link is arbitrated by weighted max-min fairness
(repro_torch.qos.arbiter); each device's data stage is capped at its granted
share, and every device's external index accesses see the congested tier
latency (repro_torch.qos / tiers.congested_latency) at the link's total load.

Multi-expander mode (``simulate_multi_expander``): devices spread over a
POOL of expanders, each with its own link.  A skewed placement (every
device on expander 0, siblings idle) saturates one link; hot-page
migration (repro_torch.qos.migration.plan_rebalance) then rebalances placement
and the per-device p99 recovers toward the uncontended baseline — at the
cost of the migrated bytes crossing both links once.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.overlap import exposed_latency_s
from repro_torch.core.tiers import congested_latency
from repro_torch.obs.trace import GLOBAL_TRACER
from repro_torch.qos.arbiter import jain_fairness, weighted_max_min
from repro_torch.qos.migration import plan_rebalance
from repro_torch.sim.ssd import Scheme, SSDSpec
from repro_torch.sim.workload import Workload, locality_hits


def recovery_fraction(hot_before_us: float, hot_after_us: float,
                      baseline_us: float) -> float:
    """1.0 = the contended p99 fully recovered to the uncontended
    baseline; 0.0 = the intervention didn't help.  Guarded against the
    zero/negative-denominator case: when the contended and baseline p99
    coincide (nothing was lost) the answer is full recovery, not a
    divide-by-zero.  Shared by :class:`MultiExpanderResult` and the
    rack-scale failover metrics (repro_torch.rack.scenarios)."""
    gap = hot_before_us - baseline_us
    if gap <= 0:
        return 1.0
    rec = (hot_before_us - hot_after_us) / gap
    return float(min(max(rec, 0.0), 1.0))


@dataclasses.dataclass
class SimResult:
    scheme: str
    workload: str
    device: str
    n_ios: int
    wall_s: float
    iops: float
    bandwidth_MBps: float
    mean_lat_us: float
    p99_lat_us: float
    index_hit_ratio: float

    def row(self) -> str:
        return (f"{self.device},{self.workload},{self.scheme},"
                f"{self.iops:.0f},{self.bandwidth_MBps:.1f},"
                f"{self.mean_lat_us:.2f},{self.p99_lat_us:.2f}")


def _lane_to_result(spec: SSDSpec, scheme: Scheme, workload: Workload,
                    lanes, i: int, device: Optional[str] = None) -> SimResult:
    """One lane of a ``repro_torch.rack.des.LaneResult`` as a SimResult."""
    iops = float(lanes.iops[i])
    result = SimResult(
        scheme=scheme.name, workload=workload.name,
        device=device or spec.name,
        n_ios=lanes.n_ios, wall_s=float(lanes.wall_s[i]), iops=iops,
        bandwidth_MBps=iops * workload.io_bytes / 1e6,
        mean_lat_us=float(lanes.mean_lat_s[i] * 1e6),
        p99_lat_us=float(lanes.p99_lat_s[i] * 1e6),
        index_hit_ratio=float(lanes.index_hit_ratio[i]),
    )
    tr = GLOBAL_TRACER
    if tr.enabled:
        tr.add("sim.run", tr.now(), result.wall_s, op="sim",
               nbytes=result.n_ios * workload.io_bytes, scheme=scheme.name,
               workload=workload.name, device=result.device,
               iops=round(iops), p99_us=round(result.p99_lat_us, 2))
    return result


def simulate(spec: SSDSpec, scheme: Scheme, workload: Workload,
             seed: Optional[int] = None, *,
             data_rate_cap_iops: Optional[float] = None,
             link_utilization: float = 0.0,
             prefetch_depth: int = 0,
             extra_index_latency_s: float = 0.0,
             engine: str = "vector") -> SimResult:
    """Closed-loop DES of one device.

    ``data_rate_cap_iops`` throttles the data stage below the device's
    Table-3 rate — the granted share of a shared expander link in
    multi-device mode.  ``link_utilization`` inflates the external index
    latency by the queueing model (0.0 = seed behaviour: alone on the
    link).  ``prefetch_depth`` models a sequential lookahead of that
    many IOs: the external L2P access for IO *i* issues while the
    preceding ``depth`` IOs occupy the data stage, hiding up to that
    compute window of its latency (repro_torch.core.overlap) — bandwidth is
    hideable behind compute, but the index engine's service rate is
    not, and random/zipf patterns (no predictable next index) get no
    hiding at all: the demand-only parity case.
    ``extra_index_latency_s`` adds a fabric path cost (a
    :class:`repro_torch.rack.topology.PathCost` latency) to every external
    index access — 0.0 is the direct-attach degenerate case.

    ``engine`` selects the execution core: ``"vector"`` (default) runs
    the lockstep struct-of-arrays core (``repro_torch.rack.des``); ``"scalar"``
    is the original per-IO Python loop, kept as the reference the
    regression tests and the rack_sweep speedup gate compare against.
    Both produce the same seeded results to floating-point tolerance.
    """
    if engine not in ("vector", "scalar"):
        raise ValueError(f"unknown engine {engine!r} "
                         "(choose 'vector' or 'scalar')")
    lane_seed = workload.seed if seed is None else seed
    if engine == "vector":
        from repro_torch.rack.des import simulate_lanes
        lanes = simulate_lanes(
            spec, scheme, workload, seeds=[lane_seed],
            data_rate_cap_iops=data_rate_cap_iops,
            link_utilization=link_utilization,
            extra_index_latency_s=extra_index_latency_s,
            prefetch_depth=prefetch_depth)
        return _lane_to_result(spec, scheme, workload, lanes, 0)
    n = workload.n_ios
    qd = workload.queue_depth
    pattern, op = workload.pattern, workload.op

    # ---- stage rates ------------------------------------------------------
    data_rate = spec.base_iops(pattern, op)
    if data_rate_cap_iops is not None:
        data_rate = min(data_rate, max(data_rate_cap_iops, 1.0))
    # Table-3 latencies are QD1 figures; at QD=64 the device pipelines, so
    # the steady-state per-IO latency is qd/rate (Little) — whichever is
    # smaller binds.  Without this the Ideal scheme could never reach the
    # device's own spec-sheet IOPS at the paper's queue depth.
    data_lat = min(spec.base_latency_s(op), qd / data_rate)

    engine = spec.index_rand if pattern in ("rand", "zipf") else spec.index_seq
    needs_index = scheme.t_tier_s is not None and (
        op == "read" or scheme.write_through_index)
    if needs_index:
        if scheme.name == "dftl":
            # flash-resident index: single outstanding flash index op
            # (flash is device-local — link congestion does not apply)
            index_rate = spec.dftl_concurrency / scheme.t_tier_s
            index_lat = scheme.t_tier_s
        else:
            # Congestion adds *waiting* to each external access; the
            # throughput cost of sharing is already the arbiter's grant cap
            # (data_rate_cap_iops), so inflating the engine's sustained
            # rate as well would double-count the link.
            t_eff = scheme.t_tier_s + extra_index_latency_s
            index_rate = engine.rate(t_eff)
            index_lat = congested_latency(t_eff, link_utilization)
            if prefetch_depth > 0 and pattern == "seq":
                # lookahead window = the data-stage service time of the
                # depth preceding IOs; only the latency the window can't
                # cover stays exposed (congestion inflation included —
                # outstanding transfers hide queueing too)
                index_lat = exposed_latency_s(
                    index_lat, prefetch_depth / data_rate)
    else:
        index_rate, index_lat = float("inf"), 0.0

    hit_ratio = scheme.onboard_hit_ratio
    hits = locality_hits(n, hit_ratio, lane_seed) if needs_index \
        else np.ones(n, dtype=bool)

    # ---- closed-loop DES ---------------------------------------------------
    # worker completion heap holds the times the qd slots free up
    slots: List[float] = [0.0] * qd
    heapq.heapify(slots)
    index_free = 0.0
    data_free = 0.0
    lat = np.empty(n)
    t_end = 0.0
    inv_data = 1.0 / data_rate
    inv_index = (1.0 / index_rate) if index_rate != float("inf") else 0.0

    for i in range(n):
        start = heapq.heappop(slots)
        t = start
        if needs_index and not hits[i]:
            issue = max(t, index_free)
            index_free = issue + inv_index
            t = issue + index_lat
        issue = max(t, data_free)
        data_free = issue + inv_data
        t = issue + data_lat
        lat[i] = t - start
        t_end = max(t_end, t)
        heapq.heappush(slots, t)

    wall = t_end
    iops = n / wall
    result = SimResult(
        scheme=scheme.name, workload=workload.name, device=spec.name,
        n_ios=n, wall_s=wall, iops=iops,
        bandwidth_MBps=iops * workload.io_bytes / 1e6,
        mean_lat_us=float(lat.mean() * 1e6),
        p99_lat_us=float(np.percentile(lat, 99) * 1e6),
        index_hit_ratio=float(hits.mean()) if needs_index else 1.0,
    )
    tr = GLOBAL_TRACER
    if tr.enabled:
        # one summary span per simulated run (dur = VIRTUAL wall time,
        # like the link.xfer convention) so benchmark traces show the
        # fig6/fabric sweeps alongside the live-system spans
        tr.add("sim.run", tr.now(), wall, op="sim",
               nbytes=n * workload.io_bytes, scheme=scheme.name,
               workload=workload.name, device=spec.name,
               iops=round(iops), p99_us=round(result.p99_lat_us, 2))
    return result


# ---------------------------------------------------------------------------
# Multi-device shared-fabric mode (repro_torch.qos)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SharedFabricResult:
    """N devices sharing one expander link (the paper's scalability case)."""

    n_devices: int
    link_bandwidth_Bps: float
    weights: List[float]
    per_device: List[SimResult]
    #: one device's unconstrained link demand (B/s)
    demand_Bps: float
    #: weighted max-min grants actually scheduled onto the link (B/s)
    grants_Bps: List[float]
    #: sum of achieved per-device goodput through the link (B/s)
    aggregate_goodput_Bps: float
    #: offered load relative to link capacity (>= achieved utilization)
    offered_utilization: float
    fairness_jain: float
    mean_p99_us: float

    def row(self) -> str:
        return (f"{self.n_devices},{self.aggregate_goodput_Bps/1e9:.2f},"
                f"{self.offered_utilization:.2f},{self.fairness_jain:.3f},"
                f"{self.mean_p99_us:.1f}")


def simulate_shared_fabric(spec: SSDSpec, scheme: Scheme, workload: Workload,
                           n_devices: int,
                           link_bandwidth_Bps: float = 30e9,
                           weights: Optional[Sequence[float]] = None,
                           prefetch_depth: int = 0,
                           engine: str = "vector",
                           ) -> SharedFabricResult:
    """Fig-6 pipeline × N devices hammering ONE expander.

    Each device stages its IO payloads through the expander (the paper's
    shared-buffer scenario), so every IO moves ``workload.io_bytes`` over
    the link.  The link is divided by weighted max-min fairness
    (:func:`repro_torch.qos.arbiter.weighted_max_min`); each device's data stage
    is capped at its grant and its external index accesses see the
    congested tier latency at the link's offered load.  ``prefetch_depth``
    gives every device the sequential-lookahead latency hiding modeled in
    :func:`simulate` — prefetch bandwidth rides behind the data stage, so
    it raises goodput without changing the arbiter's fairness math.
    """
    if weights is None:
        weights = [1.0] * n_devices
    if len(weights) != n_devices:
        raise ValueError(f"{len(weights)} weights for {n_devices} devices")

    # one device's unconstrained throughput = its sustained link demand
    base = simulate(spec, scheme, workload, prefetch_depth=prefetch_depth,
                    engine=engine)
    demand_Bps = base.iops * workload.io_bytes

    names = [f"dev{i}" for i in range(n_devices)]
    grants = weighted_max_min(
        {nm: demand_Bps for nm in names},
        {nm: w for nm, w in zip(names, weights)},
        link_bandwidth_Bps)
    offered = min(n_devices * demand_Bps / link_bandwidth_Bps, 1.0)

    per_device: List[SimResult] = []
    if engine == "vector":
        # all devices advance as lockstep lanes of one vectorized run
        from repro_torch.rack.des import simulate_lanes
        lanes = simulate_lanes(
            spec, scheme, workload,
            seeds=[workload.seed + i for i in range(n_devices)],
            data_rate_cap_iops=[grants[nm] / workload.io_bytes
                                for nm in names],
            link_utilization=offered,
            prefetch_depth=prefetch_depth)
        for i in range(n_devices):
            per_device.append(_lane_to_result(
                spec, scheme, workload, lanes, i,
                device=f"{spec.name}#{i}"))
    else:
        for i, nm in enumerate(names):
            r = simulate(spec, scheme, workload, seed=workload.seed + i,
                         data_rate_cap_iops=grants[nm] / workload.io_bytes,
                         link_utilization=offered,
                         prefetch_depth=prefetch_depth, engine=engine)
            per_device.append(
                dataclasses.replace(r, device=f"{r.device}#{i}"))

    goodputs = [r.iops * workload.io_bytes for r in per_device]
    return SharedFabricResult(
        n_devices=n_devices,
        link_bandwidth_Bps=link_bandwidth_Bps,
        weights=list(weights),
        per_device=per_device,
        demand_Bps=demand_Bps,
        grants_Bps=[grants[nm] for nm in names],
        aggregate_goodput_Bps=float(sum(goodputs)),
        offered_utilization=offered,
        fairness_jain=jain_fairness(goodputs),
        mean_p99_us=float(np.mean([r.p99_lat_us for r in per_device])),
    )


# ---------------------------------------------------------------------------
# Multi-expander pool + hot-page migration (repro_torch.qos.migration)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MultiExpanderResult:
    """Skewed placement on a pooled fabric, before/after migration."""

    n_devices: int
    n_expanders: int
    link_bandwidth_Bps: float
    #: one device's unconstrained link demand (B/s)
    demand_Bps: float
    placement_before: List[int]          # device index -> expander id
    placement_after: List[int]
    #: per-expander offered load (rho) in each phase
    utilization_before: List[float]
    utilization_after: List[float]
    per_device_before: List[SimResult]
    per_device_after: List[SimResult]
    #: one device alone on an idle link (the recovery target)
    baseline_p99_us: float
    #: mean p99 of the devices placed on the initially-hot expander
    hot_p99_before_us: float
    hot_p99_after_us: float
    migrated_devices: int
    #: LMB-resident bytes that crossed links to realize the new placement
    migrated_bytes: int
    #: serialized time the migration traffic occupies a link
    migration_wall_s: float

    @property
    def recovery_fraction(self) -> float:
        """1.0 = hot-expander p99 fully recovered to the uncontended
        baseline; 0.0 = migration didn't help."""
        return recovery_fraction(self.hot_p99_before_us,
                                 self.hot_p99_after_us,
                                 self.baseline_p99_us)

    def row(self) -> str:
        return (f"{self.n_devices},{self.n_expanders},"
                f"{self.hot_p99_before_us:.1f},{self.hot_p99_after_us:.1f},"
                f"{self.baseline_p99_us:.1f},{self.recovery_fraction:.2f},"
                f"{self.migrated_bytes/2**20:.0f}MiB")


def simulate_multi_expander(spec: SSDSpec, scheme: Scheme,
                            workload: Workload, n_devices: int,
                            n_expanders: int = 2,
                            link_bandwidth_Bps: float = 30e9,
                            placement: Optional[Sequence[int]] = None,
                            resident_bytes_per_device: int = 64 * 2**20,
                            saturation_threshold: float = 0.7,
                            engine: str = "vector",
                            ) -> MultiExpanderResult:
    """Pooled fabric: ``n_devices`` spread over ``n_expanders`` links.

    Default placement is the worst case the MigrationEngine exists for:
    every device homed on expander 0 (hot) while the siblings idle.  Phase
    one simulates that skew; :func:`repro_torch.qos.migration.plan_rebalance`
    then migrates load (modeling the engine's hottest-pages-first policy at
    device granularity — a device's resident LMB bytes move with it) and
    phase two simulates the rebalanced pool.
    """
    if placement is None:
        placement = [0] * n_devices
    placement = list(placement)
    if len(placement) != n_devices:
        raise ValueError(f"{len(placement)} placements for {n_devices}")
    if any(not 0 <= p < n_expanders for p in placement):
        raise ValueError("placement references unknown expander")

    base = simulate(spec, scheme, workload, engine=engine)
    demand_Bps = base.iops * workload.io_bytes

    def phase(place: Sequence[int]) -> tuple:
        # per-expander arbitration first (pure bookkeeping), then ONE
        # vectorized run with per-lane caps/utilizations for the whole pool
        by_exp: Dict[int, List[int]] = {}
        for dev, eid in enumerate(place):
            by_exp.setdefault(eid, []).append(dev)
        rhos = [0.0] * n_expanders
        caps = np.empty(n_devices)
        utils = np.empty(n_devices)
        for eid in range(n_expanders):
            devs = by_exp.get(eid, [])
            if not devs:
                continue
            rho = min(len(devs) * demand_Bps / link_bandwidth_Bps, 1.0)
            rhos[eid] = rho
            grants = weighted_max_min(
                {f"dev{d}": demand_Bps for d in devs},
                {f"dev{d}": 1.0 for d in devs}, link_bandwidth_Bps)
            for d in devs:
                caps[d] = grants[f"dev{d}"] / workload.io_bytes
                utils[d] = rho
        results: List[Optional[SimResult]] = [None] * n_devices
        if engine == "vector":
            from repro_torch.rack.des import simulate_lanes
            lanes = simulate_lanes(
                spec, scheme, workload,
                seeds=[workload.seed + d for d in range(n_devices)],
                data_rate_cap_iops=caps, link_utilization=utils)
            for d in range(n_devices):
                results[d] = _lane_to_result(
                    spec, scheme, workload, lanes, d,
                    device=f"{spec.name}#{d}@x{place[d]}")
        else:
            for d in range(n_devices):
                r = simulate(
                    spec, scheme, workload, seed=workload.seed + d,
                    data_rate_cap_iops=float(caps[d]),
                    link_utilization=float(utils[d]), engine=engine)
                results[d] = dataclasses.replace(
                    r, device=f"{r.device}#{d}@x{place[d]}")
        return results, rhos

    before, rhos_before = phase(placement)
    after_placement = plan_rebalance(
        [demand_Bps] * n_devices, placement, n_expanders,
        link_bandwidth_Bps, saturation_threshold)
    after, rhos_after = phase(after_placement)

    moved = [d for d in range(n_devices)
             if after_placement[d] != placement[d]]
    migrated_bytes = len(moved) * resident_bytes_per_device
    # the hot expander is wherever the initial load actually peaks (the
    # default all-on-0 placement makes that expander 0, but a caller
    # placement may skew any link)
    hot_eid = int(np.argmax(rhos_before))
    hot = [d for d in range(n_devices) if placement[d] == hot_eid]

    return MultiExpanderResult(
        n_devices=n_devices,
        n_expanders=n_expanders,
        link_bandwidth_Bps=link_bandwidth_Bps,
        demand_Bps=demand_Bps,
        placement_before=placement,
        placement_after=after_placement,
        utilization_before=rhos_before,
        utilization_after=rhos_after,
        per_device_before=before,
        per_device_after=after,
        baseline_p99_us=base.p99_lat_us,
        hot_p99_before_us=float(np.mean(
            [before[d].p99_lat_us for d in hot])) if hot else 0.0,
        hot_p99_after_us=float(np.mean(
            [after[d].p99_lat_us for d in hot])) if hot else 0.0,
        migrated_devices=len(moved),
        migrated_bytes=migrated_bytes,
        migration_wall_s=migrated_bytes / link_bandwidth_Bps,
    )
