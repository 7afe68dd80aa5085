"""The window's latency and rate arithmetic, from the stamps the driver took.

Every token is stamped with the host clock when the ``ServeEngine.step``
call that produced it returned (a round ends in a host sync, so the token
exists then).  A request is due when its client sent it.  The window is
``(start, end]``.

* tokens: every stamp in the window, of finished requests and unfinished;
* gaps: each interval between consecutive tokens of one request whose
  later token falls in the window;
* TTFT: each request due in ``[start, end)``, from due to its first token;
  one with no token by ``end`` counts at its age then (censored), as does
  one that failed.

Percentiles are the linear interpolation between order statistics (numpy's
default, ``method="linear"``) over every sample, never a median of chunks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class Stamped:
    """What the driver knows of one request."""

    due: float
    tokens: List[float] = dataclasses.field(default_factory=list)
    failed: bool = False


def percentile(values, q: float) -> float:
    if len(values) == 0:
        raise ValueError("no samples")
    return float(np.percentile(np.asarray(values, np.float64), q))


def window_tokens(reqs: List[Stamped], start: float, end: float) -> int:
    return sum(1 for r in reqs for t in r.tokens if start < t <= end)


def window_gaps(reqs: List[Stamped], start: float, end: float
                ) -> List[float]:
    return [b - a for r in reqs for a, b in zip(r.tokens, r.tokens[1:])
            if start < b <= end]


def window_ttfts(reqs: List[Stamped], start: float, end: float
                 ) -> Dict[str, object]:
    """TTFT samples of the requests due in the window, and how many of
    them were censored (no token by ``end``) or failed."""
    out, censored, failed = [], 0, 0
    for r in reqs:
        if not start <= r.due < end:
            continue
        first = r.tokens[0] if r.tokens else None
        if r.failed:
            failed += 1
            out.append(end - r.due)
        elif first is None or first > end:
            censored += 1
            out.append(end - r.due)
        else:
            out.append(first - r.due)
    return {"samples": out, "censored": censored, "failed": failed}


def summary(reqs: List[Stamped], start: float, end: float) -> dict:
    """The end-to-end figures of one window, with their sample counts."""
    secs = end - start
    gaps = window_gaps(reqs, start, end)
    ttft = window_ttfts(reqs, start, end)
    toks = window_tokens(reqs, start, end)
    out = {"window_s": secs, "tokens": toks, "tokens_per_s": toks / secs,
           "gaps": len(gaps), "ttft_requests": len(ttft["samples"]),
           "ttft_censored": ttft["censored"], "ttft_failed": ttft["failed"]}
    if gaps:
        out["itl_p95_ms"] = 1e3 * percentile(gaps, 95)
        out["itl_p50_ms"] = 1e3 * percentile(gaps, 50)
    if ttft["samples"]:
        out["ttft_p95_ms"] = 1e3 * percentile(ttft["samples"], 95)
        out["ttft_p50_ms"] = 1e3 * percentile(ttft["samples"], 50)
    return out
