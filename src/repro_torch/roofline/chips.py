"""Per-chip constants the roofline and the dry run divide by.

``H100_SXM`` holds figures from NVIDIA's H100 datasheet (SXM5 part, dense
rates, no sparsity, at the full 700 W power limit).  They are
specifications, not measurements: a card set below 700 W runs slower
under load.  ``TPU_V5E`` holds the reference package's v5e figures,
read from the port's copy of ``core/tiers.py``; it exists so that tests
can reproduce the reference's roofline numbers, and is never the card's.

The collective term divides per-device link bytes by ``link_Bps``.  For
the H100 that is NVLink's 450 GB/s per direction, which holds only inside
one 8-GPU NVLink domain: a 16-wide ``model`` axis spans two domains, and
its traffic across them runs over slower links, so the term at NVLink
speed is a lower bound.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.tiers import (TPU_HBM_BW_Bps, TPU_HBM_BYTES,
                                    TPU_ICI_BW_Bps, TPU_PEAK_FLOPS)


@dataclasses.dataclass(frozen=True)
class Chip:
    name: str
    #: peak dense bf16 FLOP/s
    peak_flops: float
    #: HBM bandwidth, B/s
    hbm_Bps: float
    #: HBM capacity, bytes
    hbm_bytes: float
    #: per-chip link bandwidth for the collective term, B/s per direction
    link_Bps: float
    #: per-device training/serving state above which the dry run shards
    #: parameters over the batch axes too (FSDP)
    fsdp_threshold_bytes: float


#: NVIDIA H100 SXM5 datasheet: 989.4 TFLOP/s bf16 dense, 3.35 TB/s HBM3,
#: 80 GB, NVLink 4 at 900 GB/s bidirectional (450 GB/s each way); FSDP
#: past half of HBM
H100_SXM = Chip("H100-SXM (datasheet)", peak_flops=989.4e12,
                hbm_Bps=3.35e12, hbm_bytes=80e9, link_Bps=450e9,
                fsdp_threshold_bytes=40e9)

#: the reference's TPU v5e figures (``core/tiers.py``) and its FSDP
#: threshold (``repro/launch/dryrun.py``'s 8e9, half a v5e's HBM)
TPU_V5E = Chip("TPU v5e (reference)", peak_flops=TPU_PEAK_FLOPS,
               hbm_Bps=TPU_HBM_BW_Bps, hbm_bytes=TPU_HBM_BYTES,
               link_Bps=TPU_ICI_BW_Bps, fsdp_threshold_bytes=8e9)
