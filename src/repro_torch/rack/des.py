"""Vectorized discrete-event core: many device lanes in lockstep.

The scalar engine (``repro_torch.sim.engine.simulate``) advances one IO at a
time through a closed-loop queue-depth pipeline — exact, but a Python
loop per IO caps it at a handful of devices.  This module re-expresses
the same recurrence as a numpy struct-of-arrays computation over many
independent *lanes* (one lane = one simulated device), which is what
makes rack-scale scenarios (hundreds of devices x millions of IOs)
reachable.

The scalar recurrence, per IO ``i`` (miss = external index access):

    start_i = pop(min slot)                      # closed loop, QD slots
    v_i  = max(start_i, index_free);  index_free = v_i + 1/index_rate
    w_i  = v_i + index_lat                       # (miss only; else start_i)
    s_i  = max(w_i, data_free);       data_free  = s_i + 1/data_rate
    t_i  = s_i + data_lat;            lat_i = t_i - start_i

Two structural facts make it vectorizable without changing the math:

  1. **Completions are strictly increasing** (``s_{i+1} >= s_i +
     1/data_rate``), so the slot heap degenerates to a FIFO ring:
     ``start_i = t_{i-qd}`` (0 for the first ``qd`` IOs).  The feedback
     loop therefore has lag ``qd`` — IOs can be processed in chunks of
     ``qd`` with all starts known up front.
  2. **Each stage is a max-plus prefix scan.**  With ``g = 1/rate`` and
     ordinal ``j`` inside a chunk, ``s_j = max(w_j, s_{j-1} + g)``
     rewrites to ``s_j - g*j = max(w_j - g*j, s_{j-1} - g*(j-1))`` — a
     running maximum (``np.maximum.accumulate``) in the transformed
     coordinate, seeded with the stage's carry-in next-free time.

Every lane shares the chunk loop, so the Python-level iteration count
is ``n_ios / qd`` **independent of the number of lanes**; all per-IO
work is numpy over ``(lanes, qd)`` blocks.  Results match the scalar
engine to floating-point association order (regression tests pin
p50/p99 agreement within tolerance).

Per-lane parameters (bandwidth grant caps, link utilization, extra
path latency from :class:`repro_torch.rack.topology.RackTopology` hop costs,
RNG seeds) are arrays, which is how ``simulate_shared_fabric`` /
``simulate_multi_expander`` and the rack scenarios express whole racks
as a single call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.core.overlap import exposed_latency_s
from repro_torch.core.tiers import congested_latency
from repro_torch.sim.ssd import Scheme, SSDSpec
from repro_torch.sim.workload import Workload, batch_locality_hits

_ArrayLike = Union[float, Sequence[float], np.ndarray]


@dataclasses.dataclass
class LaneResult:
    """Per-lane (per-device) outcome arrays of one vectorized run."""

    n_lanes: int
    n_ios: int
    wall_s: np.ndarray           # (L,) completion time of the last IO
    iops: np.ndarray             # (L,)
    mean_lat_s: np.ndarray       # (L,)
    p50_lat_s: np.ndarray        # (L,)
    p99_lat_s: np.ndarray        # (L,)
    index_hit_ratio: np.ndarray  # (L,)

    @property
    def total_ios(self) -> int:
        return self.n_lanes * self.n_ios


def _per_lane(value: _ArrayLike, n_lanes: int, name: str) -> np.ndarray:
    arr = np.broadcast_to(np.asarray(value, np.float64), (n_lanes,))
    if arr.shape != (n_lanes,):
        raise ValueError(f"{name}: expected scalar or ({n_lanes},) array")
    return np.ascontiguousarray(arr)


def simulate_lanes(spec: SSDSpec, scheme: Scheme, workload: Workload,
                   *, seeds: Sequence[int],
                   data_rate_cap_iops: Optional[_ArrayLike] = None,
                   link_utilization: _ArrayLike = 0.0,
                   extra_index_latency_s: _ArrayLike = 0.0,
                   prefetch_depth: int = 0) -> LaneResult:
    """Closed-loop DES of ``len(seeds)`` independent device lanes.

    Mirrors :func:`repro_torch.sim.engine.simulate` parameter-for-parameter,
    vectorized: ``data_rate_cap_iops`` and ``link_utilization`` may be
    per-lane arrays (the arbiter grant / offered load of each device's
    link), and ``extra_index_latency_s`` adds a per-lane fabric path
    latency (:class:`~repro_torch.rack.topology.PathCost.latency_s` of the
    device's host->expander route) to every external index access —
    direct attach is the 0.0 degenerate case.  Locality draws come from
    :func:`repro_torch.sim.workload.batch_locality_hits`, seeded per lane
    exactly like the scalar engine, so hit/miss populations (and
    therefore results) line up lane-for-lane with scalar runs.
    """
    L = len(seeds)
    if L < 1:
        raise ValueError("at least one lane required")
    n = workload.n_ios
    qd = workload.queue_depth
    pattern, op = workload.pattern, workload.op

    caps = (None if data_rate_cap_iops is None
            else _per_lane(data_rate_cap_iops, L, "data_rate_cap_iops"))
    utils = _per_lane(link_utilization, L, "link_utilization")
    extra = _per_lane(extra_index_latency_s, L, "extra_index_latency_s")

    # ---- per-lane stage rates (same derivation as the scalar engine) ------
    data_rate = np.full(L, spec.base_iops(pattern, op))
    if caps is not None:
        data_rate = np.minimum(data_rate, np.maximum(caps, 1.0))
    data_lat = np.minimum(spec.base_latency_s(op), qd / data_rate)

    engine = spec.index_rand if pattern in ("rand", "zipf") else spec.index_seq
    needs_index = scheme.t_tier_s is not None and (
        op == "read" or scheme.write_through_index)
    if needs_index:
        if scheme.name == "dftl":
            # flash-resident index is device-local: neither link
            # congestion nor fabric hop latency applies
            index_rate = np.full(L, spec.dftl_concurrency / scheme.t_tier_s)
            index_lat = np.full(L, scheme.t_tier_s)
        else:
            t_eff = scheme.t_tier_s + extra      # tier + fabric path cost
            index_rate = engine.concurrency / (engine.t_proc_s + t_eff)
            index_lat = np.array(
                [congested_latency(t, u) for t, u in zip(t_eff, utils)])
            if prefetch_depth > 0 and pattern == "seq":
                index_lat = np.array(
                    [exposed_latency_s(il, prefetch_depth / dr)
                     for il, dr in zip(index_lat, data_rate)])
        inv_index = 1.0 / index_rate
        hit_ratio = scheme.onboard_hit_ratio
        hits = batch_locality_hits(n, hit_ratio, seeds)
        miss = ~hits
    else:
        index_lat = inv_index = None
        miss = None

    # ---- lockstep chunked max-plus scan -----------------------------------
    # Everything feedback-independent is hoisted out of the chunk loop and
    # computed for ALL chunks in one vectorized pass: per-chunk miss
    # ordinals (cumsum over a reshaped (L, n_chunks, qd) view), the
    # g*j transform products, and the data-stage ramp.  The loop body is
    # then just the two max-plus scans on preallocated buffers — the
    # Python-level work per chunk is a handful of in-place ufunc calls.
    inv_data = 1.0 / data_rate
    n_pad = -(-n // qd) * qd             # ceil to whole chunks
    data_lat_c = data_lat[:, None]
    ramp = inv_data[:, None] * np.arange(qd)       # (L, qd) data transform
    # Fast path: most schemes run at hit_ratio 0 — EVERY IO misses, so the
    # per-chunk miss ordinal is just 0..c-1 in every lane and chunk, and
    # the where/copyto hit-masking machinery drops out entirely.
    uniform = needs_index and bool(miss.all())
    if uniform:
        ramp_i = inv_index[:, None] * np.arange(qd)
        # index->data handoff folded into one constant: w - ramp =
        # (cm + ramp_i + index_lat) - ramp
        delta = ramp_i + index_lat[:, None] - ramp
        ramp_lat = ramp + data_lat_c                   # issue -> completion
    elif needs_index:
        mp = np.zeros((L, n_pad), dtype=bool)
        mp[:, :n] = miss
        j3 = np.cumsum(mp.reshape(L, -1, qd), axis=2)  # (L, nc, qd) ordinals
        n_miss3 = j3[:, :, -1]                          # misses per chunk
        j3 = j3 - 1
        prod3 = inv_index[:, None, None] * j3           # g*j, all chunks
        back3 = prod3 + index_lat[:, None, None]        # undo + tier latency
        keep3 = ~mp.reshape(L, -1, qd)                  # hit positions
    lat = np.empty((L, n))
    starts = np.zeros((L, qd))           # ring: completions one chunk back
    index_free = np.zeros((L, 1))
    data_free = np.zeros((L, 1))
    a = np.empty((L, qd))
    b = np.empty((L, qd))
    for k, c0 in enumerate(range(0, n, qd)):
        c = min(qd, n - c0)
        u = starts[:, :c]
        if uniform:
            np.subtract(u, ramp_i[:, :c], out=a[:, :c])
            np.maximum.accumulate(a[:, :c], axis=1, out=a[:, :c])
            np.maximum(a[:, :c], index_free, out=a[:, :c])
            index_free = a[:, c - 1:c] + inv_index[:, None] * c
            np.add(a[:, :c], delta[:, :c], out=b[:, :c])
        elif needs_index:
            np.subtract(u, prod3[:, k, :c], out=a[:, :c])
            np.copyto(a[:, :c], -np.inf, where=keep3[:, k, :c])
            np.maximum.accumulate(a[:, :c], axis=1, out=a[:, :c])
            np.maximum(a[:, :c], index_free, out=a[:, :c])
            nm = n_miss3[:, k:k + 1]
            index_free = np.where(
                nm > 0, a[:, c - 1:c] + inv_index[:, None] * nm, index_free)
            w = np.add(a[:, :c], back3[:, k, :c], out=a[:, :c])
            np.copyto(w, u, where=keep3[:, k, :c])
            np.subtract(w, ramp[:, :c], out=b[:, :c])
        else:
            np.subtract(u, ramp[:, :c], out=b[:, :c])
        np.maximum.accumulate(b[:, :c], axis=1, out=b[:, :c])
        np.maximum(b[:, :c], data_free, out=b[:, :c])
        data_free = b[:, c - 1:c] + inv_data[:, None] * c
        if uniform:
            t = np.add(b[:, :c], ramp_lat[:, :c], out=b[:, :c])
        else:
            issue = np.add(b[:, :c], ramp[:, :c], out=b[:, :c])
            t = np.add(issue, data_lat_c, out=issue)
        np.subtract(t, u, out=lat[:, c0:c0 + c])
        starts[:, :c] = t                # FIFO: start_i = t_{i-qd}

    wall = starts[:, c - 1].copy()       # completions increase monotonically
    iops = n / wall
    p50, p99 = np.percentile(lat, (50, 99), axis=1)  # one partition pass
    return LaneResult(
        n_lanes=L, n_ios=n, wall_s=wall, iops=iops,
        mean_lat_s=lat.mean(axis=1),
        p50_lat_s=p50,
        p99_lat_s=p99,
        index_hit_ratio=(1.0 - miss.mean(axis=1) if needs_index
                         else np.ones(L)),
    )
