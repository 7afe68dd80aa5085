"""Rack-level experiments on the switched-topology + vectorized-DES stack.

Four scenario families, published through ``benchmarks/run.py --only
rack_sweep`` (each row carries declarative :class:`benchmarks.run.Gate`
bounds enforced by ``tools/check_bench_regression.py``):

  * :func:`hop_cost_sweep` — the same device behind deeper and deeper
    fabric paths (direct -> same-leaf -> cross-leaf -> cross-pod); p99
    index latency must grow monotonically with hop cost.
  * :func:`placement_face_off` — skewed placement (every device piled on
    one cross-leaf expander) vs the topology-aware ``pool-aware`` policy
    (near-first, capacity-balanced) and the topology-blind spread, all
    simulated from placements the REAL FabricManager produced.
  * :func:`failover_recovery` — correlated failure: a whole leaf's power
    domain dies, its devices pile onto one survivor, and
    :func:`repro_torch.qos.migration.plan_rebalance` (``alive=`` survivors)
    replays the PR-2 migration planner as domain-wide failover; the hot
    survivor's p99 must recover >= 90% of the way to the balanced-
    survivor baseline.  Also exercises the FM's
    ``inject_domain_failure`` re-grant path end to end.
  * :func:`scale_sweep` — pool-utilization / scale: 256 devices x 1M+
    simulated IOs across a 16-expander rack in one vectorized call,
    plus the measured wall-clock speedup of the vectorized core over
    the scalar reference engine on the same scenario.

Everything here consumes public seams: :class:`RackTopology` path
costs feed ``simulate_lanes(extra_index_latency_s=...)`` (the
``repro_torch.core.tiers.tier_over_path`` fold), per-expander offered load
feeds ``link_utilization``, and arbiter grants feed
``data_rate_cap_iops`` — the same wiring ``simulate_shared_fabric``
uses, at rack scale.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.trace import GLOBAL_TRACER
from repro_torch.qos.arbiter import weighted_max_min
from repro_torch.qos.migration import plan_rebalance
from repro_torch.rack.des import LaneResult, simulate_lanes
from repro_torch.rack.topology import RackTopology
from repro_torch.sim.engine import recovery_fraction, simulate
from repro_torch.sim.ssd import Scheme, SSDSpec, make_schemes
from repro_torch.sim.workload import Workload, make_workload

#: per-port link bandwidth used by every scenario (the LMB_CXL default)
LINK_BW_Bps = 30e9


def _default_model() -> Tuple[SSDSpec, Scheme]:
    from repro_torch.sim import make_ssd_model
    spec = make_ssd_model(5)
    return spec, make_schemes(spec)["lmb-cxl"]


def _pool_lanes(spec: SSDSpec, scheme: Scheme, wl: Workload,
                placement: Sequence[int], topo: RackTopology,
                host_id: str, demand_Bps: float,
                link_bandwidth_Bps: float = LINK_BW_Bps,
                ) -> Tuple[LaneResult, List[float]]:
    """One vectorized run of a whole placed pool: per-expander max-min
    grants cap each lane's data stage, per-expander offered load sets
    its congestion, and the host->expander path latency rides on every
    external index access.  Exactly ``simulate_shared_fabric``'s wiring,
    with the rack topology supplying the per-lane path costs."""
    n_dev = len(placement)
    by_exp: Dict[int, List[int]] = {}
    for dev, eid in enumerate(placement):
        by_exp.setdefault(int(eid), []).append(dev)
    caps = np.empty(n_dev)
    utils = np.empty(n_dev)
    extra = np.empty(n_dev)
    rhos = {eid: 0.0 for eid in by_exp}
    for eid, devs in by_exp.items():
        rho = min(len(devs) * demand_Bps / link_bandwidth_Bps, 1.0)
        rhos[eid] = rho
        grants = weighted_max_min(
            {f"d{d}": demand_Bps for d in devs},
            {f"d{d}": 1.0 for d in devs}, link_bandwidth_Bps)
        lat = topo.path(host_id, eid).latency_s
        for d in devs:
            caps[d] = grants[f"d{d}"] / wl.io_bytes
            utils[d] = rho
            extra[d] = lat
    lanes = simulate_lanes(
        spec, scheme, wl, seeds=[wl.seed + d for d in range(n_dev)],
        data_rate_cap_iops=caps, link_utilization=utils,
        extra_index_latency_s=extra)
    return lanes, [rhos[e] for e in sorted(rhos)]


# ---------------------------------------------------------------------------
# 1. hop-cost sweep
# ---------------------------------------------------------------------------

def _three_tier() -> RackTopology:
    """Two pods of two leaves under one spine — the cross-pod (5-hop)
    case the two-tier canned shape cannot express."""
    topo = RackTopology()
    topo.add_switch("spine")
    for pod in range(2):
        topo.add_switch(f"pod{pod}", uplink="spine")
        for leaf in range(2):
            name = f"leaf{pod}{leaf}"
            topo.add_switch(name, uplink=f"pod{pod}",
                            power_domain=f"pd{pod}{leaf}")
            topo.attach_expander(pod * 2 + leaf, name)
    topo.attach_host("h0", "leaf00")
    return topo


def hop_cost_sweep(spec: Optional[SSDSpec] = None,
                   scheme: Optional[Scheme] = None,
                   n_ios: int = 20_000) -> List[dict]:
    """One uncontended device behind ever-deeper fabric paths.  p99 and
    mean index latency must grow monotonically with path latency; the
    direct (1-hop, 0 ns) case must match the topology-free simulator."""
    if spec is None or scheme is None:
        spec, scheme = _default_model()
    wl = make_workload("randread", n_ios=n_ios)
    two = RackTopology.two_tier(2, 2, hosts_per_leaf=1)
    cases = [
        ("direct", RackTopology.direct((0,), ("h0",)).path("h0", 0)),
        ("same_leaf", two.path("h0", 0)),
        ("cross_leaf", two.path("h0", 2)),
        ("cross_pod", _three_tier().path("h0", 3)),
    ]
    rows = []
    for name, path in cases:
        lanes = simulate_lanes(spec, scheme, wl, seeds=[wl.seed],
                               extra_index_latency_s=path.latency_s)
        rows.append({
            "case": name, "hops": path.hops,
            "path_ns": path.latency_s * 1e9,
            "kiops": float(lanes.iops[0]) / 1e3,
            "p99_us": float(lanes.p99_lat_s[0]) * 1e6,
            "mean_us": float(lanes.mean_lat_s[0]) * 1e6,
        })
    return rows


# ---------------------------------------------------------------------------
# 2. skewed vs pool-aware placement
# ---------------------------------------------------------------------------

def placement_face_off(n_devices: int = 8, n_ios: int = 8192) -> dict:
    """Three placements of ``n_devices`` (all hosted on h0) over a
    2-leaf x 2-expander rack, each SIMULATED from a placement the real
    FabricManager produced or a declared worst case:

      * ``skewed``     — every device piled on one cross-leaf expander:
        one saturated far link (the rack-scale analogue of the
        migration_sweep hot/cold worst case),
      * ``spread``     — topology-blind balance over all four links
        (what least-loaded placement does without a topology): even
        load, but half the devices pay the cross-leaf hop cost,
      * ``pool-aware`` — the PoolAwarePolicy choosing through a real
        topology-wired FM: near-first, capacity-balanced over the two
        same-leaf expanders.
    """
    from repro_torch.core.fabric import make_multi_fabric
    spec, scheme = _default_model()
    wl = make_workload("randread", n_ios=n_ios)
    topo = RackTopology.two_tier(2, 2, hosts_per_leaf=1)
    demand = simulate(spec, scheme, wl).iops * wl.io_bytes

    # the pool-aware placement comes from the REAL FM machinery
    fm, _ = make_multi_fabric(4, pool_gib=4, topology=topo,
                              placement="pool-aware")
    fm.bind_host("h0")
    pool_place = []
    for d in range(n_devices):
        g = fm.request_block("h0")
        pool_place.append(fm.expander_of(g.block_id))

    placements = {
        "skewed": [2] * n_devices,
        "spread": [d % 4 for d in range(n_devices)],
        "pool_aware": pool_place,
    }
    out: Dict[str, dict] = {}
    for name, place in placements.items():
        lanes, rhos = _pool_lanes(spec, scheme, wl, place, topo, "h0",
                                  demand)
        out[name] = {
            "placement": list(place),
            "p99_us": float(lanes.p99_lat_s.mean()) * 1e6,
            "kiops_total": float(lanes.iops.sum()) / 1e3,
            "rho_max": max(rhos),
        }
    out["p99_ratio_skew_over_pool"] = (
        out["skewed"]["p99_us"] / out["pool_aware"]["p99_us"])
    out["near_fraction_pool_aware"] = (
        sum(1 for e in pool_place if e in (0, 1)) / n_devices)
    return out


# ---------------------------------------------------------------------------
# 3. correlated-failure recovery
# ---------------------------------------------------------------------------

def failover_recovery(n_devices: int = 16, n_ios: int = 8192) -> dict:
    """A whole leaf's power domain dies; the migration planner recovers.

    Phase 1 (balanced): ``n_devices`` spread 4-per-expander over a
    2-leaf rack.  Phase 2 (pile-up): domain ``pd0`` (expanders 0+1)
    fails and the naive failover lands EVERY evacuated device on the
    first survivor — one link now carries 3/4 of the rack.  Phase 3
    (recovery): :func:`plan_rebalance` with ``alive=`` survivors forces
    the evacuees off the dead domain and balances the survivors; the
    hot survivor's p99 must recover >= 90% of the way from the pile-up
    to the balanced-survivor baseline.

    Also drives the CONTROL plane end to end: a topology-wired FM with
    granted blocks takes :meth:`inject_domain_failure`, and the
    re-granted blocks must all land outside the dead domain (the
    single-pass ``_fail_locked`` property), with per-domain ``link.xfer``
    spans emitted for the trace artifact when tracing is enabled.
    """
    from repro_torch.core.fabric import DeviceClass, DeviceInfo, make_multi_fabric
    spec, scheme = _default_model()
    wl = make_workload("randread", n_ios=n_ios)
    topo = RackTopology.two_tier(2, 2, hosts_per_leaf=1)
    demand = simulate(spec, scheme, wl).iops * wl.io_bytes
    balanced = [d % 4 for d in range(n_devices)]
    survivors = [2, 3]

    # -- data plane: balanced -> pile-up -> rebalanced ----------------------
    lanes_bal, _ = _pool_lanes(spec, scheme, wl, balanced, topo, "h0",
                               demand)
    pileup = [2 if e in (0, 1) else e for e in balanced]
    lanes_pile, _ = _pool_lanes(spec, scheme, wl, pileup, topo, "h0",
                                demand)
    rebalanced = plan_rebalance([demand] * n_devices, balanced, 4,
                                LINK_BW_Bps, alive=survivors)
    lanes_reb, _ = _pool_lanes(spec, scheme, wl, rebalanced, topo, "h0",
                               demand)
    assert all(e in survivors for e in rebalanced)

    hot = [d for d in range(n_devices) if pileup[d] == 2]
    hot_pile_us = float(np.mean(
        [lanes_pile.p99_lat_s[d] for d in hot])) * 1e6
    hot_reb_us = float(np.mean(
        [lanes_reb.p99_lat_s[d] for d in hot])) * 1e6
    # the recovery target: what balanced survivors can do at all — the
    # same load the rebalanced phase carries, ideally spread
    even = [survivors[d % 2] for d in range(n_devices)]
    lanes_even, _ = _pool_lanes(spec, scheme, wl, even, topo, "h0", demand)
    target_us = float(np.mean(
        [lanes_even.p99_lat_s[d] for d in hot])) * 1e6
    recovery = recovery_fraction(hot_pile_us, hot_reb_us, target_us)

    # -- control plane: FM domain failure re-grants past the dead leaf ------
    fm, _ = make_multi_fabric(4, pool_gib=4, topology=topo)
    fm.bind_host("h0")
    for d in range(n_devices):
        fm.register_device(DeviceInfo(f"dev{d}", DeviceClass.CXL, spid=d))
    grants = [fm.request_block("h0", expander_id=balanced[d])
              for d in range(n_devices)]
    for d, g in enumerate(grants):       # per-domain link.xfer spans
        fm.meter_transfer(f"dev{d}", wl.io_bytes * 64, block_id=g.block_id)
    failed = fm.inject_domain_failure("pd0")
    stats = fm.journal_stats()["by_op"]
    homes = {fm.expander_of(g.block_id)
             for g in fm.held_grants("h0")}
    assert homes.isdisjoint(failed)
    tr = GLOBAL_TRACER
    if tr.enabled:
        for eid in sorted({*balanced}):
            tr.add("rack.recovery", tr.now(), 0.0, op="rack",
                   expander=eid, domain=topo.domain_of(eid),
                   nbytes=0, phase="failover")
    return {
        "baseline_p99_us": float(np.mean(
            [lanes_bal.p99_lat_s[d] for d in hot])) * 1e6,
        "pileup_p99_us": hot_pile_us,
        "rebalanced_p99_us": hot_reb_us,
        "target_p99_us": target_us,
        "recovery": recovery,
        "failed_expanders": list(failed),
        "regranted": stats.get("regrant", 0),
        "lost": stats.get("lost", 0),
        "moved_devices": sum(1 for a, b in zip(balanced, rebalanced)
                             if a != b),
    }


# ---------------------------------------------------------------------------
# 4. pool-utilization / scale sweep + vectorized-core speedup
# ---------------------------------------------------------------------------

def scale_sweep(n_expanders: int = 16, devices_per_expander: int = 16,
                n_ios: int = 4096) -> dict:
    """The rack-scale headline: ``n_expanders * devices_per_expander``
    devices x ``n_ios`` IOs each — 256 x 4096 = 1,048,576 simulated
    requests by default — in ONE vectorized call, with a utilization
    density sweep (4/8/16 devices per link) showing p99 climbing with
    offered load.  ``wall_s`` is measured host wall-clock; the CI gate
    bounds it (and the request count) so the vectorized core's
    rack-scale reach is a regression-checked property."""
    spec, scheme = _default_model()
    wl = make_workload("randread", n_ios=n_ios)
    leaves = max(n_expanders // 4, 1)
    topo = RackTopology.two_tier(leaves, n_expanders // leaves,
                                 hosts_per_leaf=1)
    demand = simulate(spec, scheme, wl).iops * wl.io_bytes
    density = {}
    for per in (4, 8, 16):
        if per > devices_per_expander:
            continue
        n_dev = n_expanders * per
        place = [d % n_expanders for d in range(n_dev)]
        t0 = time.perf_counter()
        lanes, rhos = _pool_lanes(spec, scheme, wl, place, topo, "h0",
                                  demand)
        wall = time.perf_counter() - t0
        density[per] = {
            "devices": n_dev,
            "requests": lanes.total_ios,
            "wall_s": wall,
            "rho_max": max(rhos),
            "p99_us": float(lanes.p99_lat_s.mean()) * 1e6,
            "agg_GBps": float(lanes.iops.sum()) * wl.io_bytes / 1e9,
        }
        tr = GLOBAL_TRACER
        if tr.enabled and per == devices_per_expander:
            for eid in range(n_expanders):
                n_on = sum(1 for e in place if e == eid)
                tr.add("rack.pool", tr.now(),
                       float(lanes.wall_s[place.index(eid)]),
                       op="rack", expander=eid,
                       domain=topo.domain_of(eid),
                       nbytes=n_on * n_ios * wl.io_bytes, devices=n_on)
    full = density[devices_per_expander]
    return {"density": density, **full}


def vector_speedup(n_lanes: int = 256, n_ios: int = 8192) -> dict:
    """Measured wall-clock of the scalar reference engine vs the
    vectorized core on the SAME scenario (``n_lanes`` independent
    seeded devices, identical results asserted) — the >= 20x speedup
    acceptance gate."""
    spec, scheme = _default_model()
    wl = make_workload("randread", n_ios=n_ios)
    seeds = [wl.seed + i for i in range(n_lanes)]
    t0 = time.perf_counter()
    scalar = [simulate(spec, scheme, wl, seed=s, engine="scalar")
              for s in seeds]
    t_scalar = time.perf_counter() - t0
    t_vector = float("inf")
    for _ in range(3):  # best-of-3: first call pays numpy buffer warmup
        t0 = time.perf_counter()
        lanes = simulate_lanes(spec, scheme, wl, seeds=seeds)
        t_vector = min(t_vector, time.perf_counter() - t0)
    agree = bool(np.allclose([r.p99_lat_us for r in scalar],
                             lanes.p99_lat_s * 1e6, rtol=1e-6))
    return {
        "lanes": n_lanes, "requests": lanes.total_ios,
        "scalar_s": t_scalar, "vector_s": t_vector,
        "speedup": t_scalar / max(t_vector, 1e-9),
        "results_agree": agree,
    }
