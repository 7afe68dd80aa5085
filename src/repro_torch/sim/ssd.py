"""SSD device models (paper Table 3) and L2P-index placement schemes.

Pipeline model
--------------
Each IO passes two stages:

  1. **L2P lookup** — resolving LBA→PPA through the mapping table.  Where the
     table lives is the *scheme*:
       Ideal     — all of it in onboard DRAM: lookup rides the device's
                   hardware-assisted path and is already part of the baseline
                   numbers (no extra cost).
       LMB-CXL   — table in the CXL expander, device reaches it P2P
                   (+190 ns per access, paper §4).
       LMB-PCIe  — table in the expander, host-forwarded (+880 ns Gen4,
                   +1190 ns Gen5).
       DFTL      — table in flash; a miss costs a flash read (+25 µs).
     External lookups flow through the device's **index engine**, a
     firmware-managed unit with limited memory-level parallelism: effective
     concurrency ``K`` over a per-lookup busy time ``t_proc + t_tier``.
  2. **media/data stage** — rate-limited by the device's baseline throughput
     (Table 3), with per-IO base latency for the closed-loop QD behaviour.

Writes post their index *updates* asynchronously (write-back mapping cache),
so memory-tier schemes show no write degradation — matching Fig 6.  DFTL
writes must read-modify-write flash-resident index pages on the critical
path.

Calibration
-----------
``K`` and ``t_proc`` are per-device and per-pattern, fitted analytically to
Fig 6's reported deltas (the paper: "Baseline performance variations between
the two SSDs result in different simulation outputs under a same condition"):

  Gen4: K≈7.9, t_proc≈4.3 µs (slow but deeply pipelined firmware lookup)
  Gen5: rand K≈2.6, t_proc≈2.0 µs; seq K≈2.3, t_proc≈0.51 µs
        (fast, shallow lookup engine → more sensitive to added latency,
        exactly the §4.1.2 observation)

These reproduce: Gen4 reads — LMB-CXL ≈ Ideal, LMB-PCIe −13…−17 %;
Gen5 reads — LMB-CXL −8 % seq / −56 % rand, LMB-PCIe −62 % / −70 %;
writes — LMB ≈ Ideal, DFTL 7–20× worse.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.tiers import (DFTL_FLASH_READ_S, LMB_CXL_ADDED_S,
                              LMB_PCIE_GEN4_ADDED_S, LMB_PCIE_GEN5_ADDED_S)
from repro_torch.sim.workload import IO_BYTES


@dataclasses.dataclass(frozen=True)
class IndexEngine:
    """Firmware lookup unit for EXTERNAL (non-onboard) index accesses."""

    concurrency: float        # effective memory-level parallelism
    t_proc_s: float           # firmware processing per lookup

    def rate(self, t_tier_s: float) -> float:
        """Sustained lookups/s when each access costs t_tier extra."""
        return self.concurrency / (self.t_proc_s + t_tier_s)


@dataclasses.dataclass(frozen=True)
class SSDSpec:
    """Table 3 device description."""

    name: str
    pcie_gen: int
    capacity_bytes: int
    rand_read_iops: float
    rand_write_iops: float
    seq_read_Bps: float
    seq_write_Bps: float
    rand_read_lat_s: float
    rand_write_lat_s: float
    index_rand: IndexEngine
    index_seq: IndexEngine
    #: DFTL flash-index path: effectively one outstanding flash index op
    dftl_concurrency: float = 1.0

    @property
    def lba_space(self) -> int:
        return self.capacity_bytes // IO_BYTES

    @property
    def l2p_bytes(self) -> int:
        # 4 B PPA per 4 KB page — the paper's 0.1 % rule
        return self.lba_space * 4

    def base_iops(self, pattern: str, op: str) -> float:
        if pattern in ("rand", "zipf"):
            return self.rand_read_iops if op == "read" else self.rand_write_iops
        bw = self.seq_read_Bps if op == "read" else self.seq_write_Bps
        return bw / IO_BYTES

    def base_latency_s(self, op: str) -> float:
        return self.rand_read_lat_s if op == "read" else self.rand_write_lat_s


GEN4_SSD = SSDSpec(
    name="pcie_gen4", pcie_gen=4, capacity_bytes=7_680_000_000_000,
    rand_read_iops=1_750_000.0, rand_write_iops=340_000.0,
    seq_read_Bps=7.2e9, seq_write_Bps=6.8e9,
    rand_read_lat_s=67e-6, rand_write_lat_s=9e-6,
    index_rand=IndexEngine(concurrency=7.86, t_proc_s=4.302e-6),
    index_seq=IndexEngine(concurrency=7.86, t_proc_s=4.360e-6),
)

GEN5_SSD = SSDSpec(
    name="pcie_gen5", pcie_gen=5, capacity_bytes=7_680_000_000_000,
    rand_read_iops=2_800_000.0, rand_write_iops=700_000.0,
    seq_read_Bps=14e9, seq_write_Bps=10e9,
    rand_read_lat_s=56e-6, rand_write_lat_s=8e-6,
    index_rand=IndexEngine(concurrency=2.64, t_proc_s=1.953e-6),
    index_seq=IndexEngine(concurrency=2.27, t_proc_s=0.514e-6),
)


@dataclasses.dataclass(frozen=True)
class Scheme:
    """An L2P-index placement scheme."""

    name: str
    #: added latency per external index access; None = onboard (no external)
    t_tier_s: Optional[float]
    #: whether index updates on writes hit the critical path
    write_through_index: bool = False
    #: fraction of lookups that hit the onboard mapping cache (§4.1.2);
    #: Fig 6 assumes 0.0 ("all indexing supported by CXL extended memory")
    onboard_hit_ratio: float = 0.0


def make_schemes(spec: SSDSpec) -> Dict[str, Scheme]:
    lmb_pcie_lat = (LMB_PCIE_GEN4_ADDED_S if spec.pcie_gen == 4
                    else LMB_PCIE_GEN5_ADDED_S)
    return {
        "ideal": Scheme("ideal", None),
        "lmb-cxl": Scheme("lmb-cxl", LMB_CXL_ADDED_S),
        "lmb-pcie": Scheme("lmb-pcie", lmb_pcie_lat),
        "dftl": Scheme("dftl", DFTL_FLASH_READ_S, write_through_index=True),
    }


def make_ssd_model(gen: int) -> SSDSpec:
    if gen == 4:
        return GEN4_SSD
    if gen == 5:
        return GEN5_SSD
    raise ValueError(f"no model for PCIe Gen{gen}")
