"""Hot-page migration between pooled expanders.

The paper assumes one expander behind the Fabric Manager; at pool scale
("My CXL Pool Obviates Your PCIe Switch", arXiv 2503.23611) the realistic
shape is several expanders, each with its own link, and the interesting
failure mode is *asymmetric saturation*: one expander's link runs hot while
a sibling idles.  Page-granular tiering/migration is the standard answer in
the CXL literature (survey, arXiv 2412.20249).

This module closes that loop on top of two existing hooks:

  * the per-expander :class:`~repro_torch.qos.arbiter.LinkArbiter` utilization
    EWMA (the saturation signal), and
  * :meth:`LinkedBuffer.migrate_pages` (the mechanism: re-granting
    SAT/IOMMU entries through the Table-2 alloc/free path, exactly like
    the failover re-grant machinery).

:class:`MigrationEngine` is the runtime policy driver: registered
LinkedBuffers expose per-page access heat; when the hottest link crosses
``saturation_threshold`` and a cooler expander exists, the engine moves
the hottest pages across and journals the event on the FM (like a DCD
capacity event).

:func:`plan_rebalance` is the pure planning analogue used by the
discrete-event simulator (``repro_torch.sim.engine.simulate_multi_expander``):
given per-device sustained demands and a device→expander placement, it
greedily rebalances until no link exceeds the threshold or no move helps.

No ``repro_torch.core`` imports at runtime (the FM and buffers arrive duck-typed
via ``register``): ``core.fabric`` imports ``repro_torch.qos.arbiter``, so a
module-level import back into core would cycle.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids the import cycle
    from repro_torch.core.buffer import LinkedBuffer
    from repro_torch.core.fabric import FabricManager


@dataclasses.dataclass(frozen=True)
class MigrationPolicy:
    """Knobs for when and how aggressively pages migrate."""

    #: source-link EWMA utilization that counts as saturated
    saturation_threshold: float = 0.7
    #: require dst utilization < src utilization - min_gap (hysteresis:
    #: stops ping-pong between two warm links)
    min_gap: float = 0.15
    #: per run_once() cap on moved pages (migration is link traffic too)
    max_pages_per_round: int = 64
    #: ignore pages cooler than this (decayed touch count).  The default
    #: keeps pages untouched for ~45 link crossings (0.95^45 ≈ 0.1) out
    #: of the batch: copying near-idle pages costs both links without
    #: reducing the hot one's load
    min_heat: float = 0.1


@dataclasses.dataclass
class MigrationReport:
    """Outcome of one MigrationEngine round."""

    triggered: bool
    src_expander: Optional[int] = None
    dst_expander: Optional[int] = None
    pages_moved: int = 0
    bytes_moved: int = 0
    #: per-expander link utilization sampled at decision time
    utilization: Dict[int, float] = dataclasses.field(default_factory=dict)
    reason: str = ""


class MigrationEngine:
    """Watches per-expander link utilization; moves hot LMB pages from the
    most-saturated expander to the least-loaded one.

    ``fm`` may be a FabricManager or an ``LMBSystem`` client session
    (anything carrying its FM as ``.fm`` — duck-typed to preserve this
    module's no-core-imports rule)."""

    def __init__(self, fm: "FabricManager",
                 policy: Optional[MigrationPolicy] = None):
        self.fm = getattr(fm, "fm", fm)
        self.policy = policy or MigrationPolicy()
        self._buffers: List["LinkedBuffer"] = []
        self.rounds = 0
        self.total_pages_moved = 0
        self.total_bytes_moved = 0

    def register(self, buf: "LinkedBuffer") -> None:
        """Track a LinkedBuffer's pages as migration candidates."""
        if buf.host.fm is not self.fm:
            raise ValueError(
                f"buffer {buf.name} belongs to a different FabricManager: "
                "its expander ids and utilization signals would not match "
                "this engine's")
        if buf not in self._buffers:
            self._buffers.append(buf)

    def run_once(self) -> MigrationReport:
        """One control-loop iteration: sample links, maybe migrate."""
        self.rounds += 1
        utils = self.fm.link_utilizations()
        report = MigrationReport(triggered=False, utilization=dict(utils))
        if len(utils) < 2:
            report.reason = "single healthy expander"
            return report
        src = max(utils, key=lambda eid: (utils[eid], -eid))
        if utils[src] < self.policy.saturation_threshold:
            report.reason = (f"hottest link {utils[src]:.2f} below "
                             f"threshold {self.policy.saturation_threshold}")
            return report
        dst = self.fm.least_loaded_expander(exclude=[src])
        if dst is None:
            report.reason = "no migration target with free capacity"
            return report
        if utils[dst] > utils[src] - self.policy.min_gap:
            report.reason = (f"gap {utils[src] - utils[dst]:.2f} below "
                             f"min_gap {self.policy.min_gap}")
            return report
        report.src_expander, report.dst_expander = src, dst
        budget = self.policy.max_pages_per_round
        for buf in self._buffers:
            if budget <= 0:
                break
            cands = buf.hottest_pages(budget, expander_id=src,
                                      min_heat=self.policy.min_heat)
            if not cands:
                continue
            # migrate_pages stops early (partial count) if the target
            # refuses growth; remaining pages stay intact on the source
            moved = buf.migrate_pages(cands, dst)
            nbytes = moved * buf.lmb_page_bytes
            budget -= moved
            report.pages_moved += moved
            report.bytes_moved += nbytes
            if moved:
                self.fm.record_migration(buf.device_id, src, dst,
                                         moved, nbytes)
            if moved < len(cands):
                report.reason = "target capacity exhausted mid-round"
                break
        report.triggered = report.pages_moved > 0
        if not report.reason:
            report.reason = ("migrated" if report.triggered
                             else "no candidate pages on the hot expander")
        self.total_pages_moved += report.pages_moved
        self.total_bytes_moved += report.bytes_moved
        # span tracer rides on the FM (duck-typed: no core import needed;
        # repro_torch.obs is a dependency leaf either way)
        tr = getattr(self.fm, "tracer", None)
        if tr is not None and tr.enabled and report.triggered:
            tr.event("migration.round", op="migrate",
                     nbytes=report.bytes_moved, expander=dst,
                     pages=report.pages_moved, src=src,
                     src_util=utils[src], dst_util=utils[dst])
        return report

    def stats(self) -> dict:
        return {
            "rounds": self.rounds,
            "pages_moved": self.total_pages_moved,
            "bytes_moved": self.total_bytes_moved,
            "buffers": len(self._buffers),
            "policy": dataclasses.asdict(self.policy),
        }


def plan_rebalance(demands_Bps: Sequence[float],
                   placement: Sequence[int],
                   n_expanders: int,
                   link_bandwidth_Bps: float,
                   saturation_threshold: float = 0.7,
                   alive: Optional[Sequence[int]] = None) -> List[int]:
    """Greedy device→expander rebalance (the simulator's migration model).

    Repeatedly moves the heaviest device off the most-loaded expander onto
    the least-loaded one, while the hottest link's offered load exceeds
    ``saturation_threshold`` and the move strictly lowers it.  Deterministic
    and conservative: never increases the maximum link load.

    ``alive`` restricts targets to the surviving expanders after a
    (correlated) failure: every device homed on a dead expander is FORCED
    off it first — least-loaded survivor, heaviest device first, no
    improvement test, because staying is not an option — and the greedy
    rebalance then runs over the survivors only.  Default: all alive.
    """
    if len(demands_Bps) != len(placement):
        raise ValueError("demands and placement length mismatch")
    live = sorted(set(range(n_expanders) if alive is None
                      else (int(e) for e in alive)))
    if not live:
        raise ValueError("no surviving expander to rebalance onto")
    if any(not 0 <= e < n_expanders for e in live):
        raise ValueError(f"alive references unknown expander: {live}")
    place = list(placement)
    loads = [0.0] * n_expanders
    for dev, eid in enumerate(place):
        loads[eid] += demands_Bps[dev]

    def rho(eid: int) -> float:
        return loads[eid] / link_bandwidth_Bps

    live_set = set(live)
    evacuees = sorted((dev for dev, eid in enumerate(place)
                       if eid not in live_set),
                      key=lambda dev: demands_Bps[dev], reverse=True)
    for dev in evacuees:
        dst = min(live, key=rho)
        loads[place[dev]] -= demands_Bps[dev]
        place[dev] = dst
        loads[dst] += demands_Bps[dev]

    while True:
        src = max(live, key=rho)
        if rho(src) <= saturation_threshold:
            break
        dst = min(live, key=rho)
        movers = sorted((dev for dev, eid in enumerate(place)
                         if eid == src),
                        key=lambda dev: demands_Bps[dev], reverse=True)
        moved = False
        for dev in movers:
            d = demands_Bps[dev]
            # only if it strictly lowers the hottest of the two links
            if max(loads[src] - d, loads[dst] + d) < loads[src]:
                place[dev] = dst
                loads[src] -= d
                loads[dst] += d
                moved = True
                break
        if not moved:
            break
    return place
