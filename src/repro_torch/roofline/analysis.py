"""Three-term roofline of a dry-run step (port of
``repro.roofline.analysis``).

    compute    = FLOPs per device / peak FLOP/s
    memory     = bytes per device / HBM B/s
    collective = weighted collective bytes per device / link B/s

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
parses the collectives out of the post-SPMD HLO text.  The port has no
HLO: the dry run's dispatch counter records each collective DTensor
issues as a ``(kind, result bytes)`` pair, and
:func:`collective_bytes_per_device` weights those pairs by the ring-traffic
factor the reference applies (an all-reduce moves about twice its tensor
per device; gathers, scatters, permutes and all-to-alls about once).  The
chip is a parameter (``roofline.chips``), ``H100_SXM`` by default.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.roofline.chips import H100_SXM, Chip

#: per-device ring traffic multiplier by collective kind
_TRAFFIC_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def collective_bytes_per_device(
        records: Iterable[Tuple[str, int]]) -> Dict[str, float]:
    """Weighted bytes per collective kind, and their ``"total"``."""
    per_kind: Dict[str, float] = {}
    for kind, nbytes in records:
        per_kind[kind] = per_kind.get(kind, 0.0) + \
            nbytes * _TRAFFIC_FACTOR[kind]
    per_kind["total"] = sum(v for k, v in per_kind.items() if k != "total")
    return per_kind


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    coll_bytes_per_dev: float
    chips: int
    model_flops: float = 0.0
    chip: Chip = H100_SXM

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline (no-overlap upper bound ≈ max; report max term)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU at the roofline bound."""
        ideal = self.model_flops / (self.chips * self.chip.peak_flops)
        return ideal / self.step_time_s if self.step_time_s else 0.0

    def row(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "chips": self.chips, "chip": self.chip.name,
        }


def roofline_terms(cost: dict, collectives: Iterable[Tuple[str, int]],
                   chips: int, model_flops: float = 0.0,
                   chip: Chip = H100_SXM) -> RooflineTerms:
    """``cost`` holds per-device ``"flops"`` and ``"bytes accessed"``;
    ``collectives`` the per-device ``(kind, bytes)`` records.  The
    ``hlo_*`` fields keep the reference's names and are global
    (per device × chips)."""
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    coll = collective_bytes_per_device(collectives)["total"]
    return RooflineTerms(
        compute_s=flops_dev / chip.peak_flops,
        memory_s=bytes_dev / chip.hbm_Bps,
        collective_s=coll / chip.link_Bps,
        hlo_flops=flops_dev * chips, hlo_bytes=bytes_dev * chips,
        coll_bytes_per_dev=coll,
        chips=chips, model_flops=model_flops, chip=chip)


def model_flops(cfg, shape, kind: Optional[str] = None) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference fwd), N = active."""
    n_active = cfg.active_param_count()
    kind = kind or shape.kind
    tokens = shape.global_batch * (shape.seq_len if kind != "decode" else 1)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens
