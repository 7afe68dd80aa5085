"""Where a traced train step's device time goes: host-to-device copies,
device-to-host copies and compute, each as busy time (the union of its
operations' intervals), and how long copies ran beside compute.

:func:`device_ops` runs one call under ``torch.profiler`` (CUPTI's
activity records, which list a CUDA graph's nodes one by one);
:func:`busy_split` reads the intervals, and needs no card.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch

#: an operation on the device: (name, start µs, duration µs)
Op = Tuple[str, float, float]


def device_ops(fn: Callable[[], object], device) -> List[Op]:
    """The device operations of one call of ``fn``, in start order.  The
    profiler's first step is a one-element fill, its warm-up, so ``fn``
    runs once."""
    from torch.profiler import ProfilerActivity, profile, schedule
    device = torch.device(device)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.zeros(1, device=device).add_(1)
        torch.cuda.synchronize(device)
        prof.step()
        fn()
        torch.cuda.synchronize(device)
        prof.step()
    return sorted(((e.name, e.time_range.start, e.time_range.elapsed_us())
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith("ProfilerStep")),
                  key=lambda o: o[1])


def kind_of(name: str) -> str:
    """``h2d`` or ``d2h`` for a copy across the link (CUPTI names them
    ``Memcpy HtoD (...)`` and ``Memcpy DtoH (...)``), else ``compute``:
    kernels, fills and copies within the card."""
    if name.startswith("Memcpy HtoD"):
        return "h2d"
    if name.startswith("Memcpy DtoH"):
        return "d2h"
    return "compute"


def _union(spans: Iterable[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(spans: Sequence[Sequence[float]]) -> float:
    return sum(b - a for a, b in spans)


def _intersect(x: Sequence[Sequence[float]],
               y: Sequence[Sequence[float]]) -> List[List[float]]:
    """The intersection of two unions of disjoint sorted intervals."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append([a, b])
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def busy_split(ops: Sequence[Op]) -> Dict[str, float]:
    """Milliseconds of a traced step: ``h2d``, ``d2h`` and ``compute``
    busy time, ``overlap`` (copies either way while compute runs),
    ``both_ways`` (H2D and D2H copies at once), ``span`` (first start to
    last end), and ``ops``, the count of operations."""
    spans = {k: _union((s, s + d) for n, s, d in ops if kind_of(n) == k)
             for k in ("h2d", "d2h", "compute")}
    copies = _union(map(tuple, spans["h2d"] + spans["d2h"]))
    out = {k: _length(v) / 1e3 for k, v in spans.items()}
    out["overlap"] = _length(_intersect(copies, spans["compute"])) / 1e3
    out["both_ways"] = _length(_intersect(spans["h2d"], spans["d2h"])) / 1e3
    out["span"] = ((max(s + d for _, s, d in ops) - min(s for _, s, _ in ops))
                   / 1e3 if ops else 0.0)
    out["ops"] = len(ops)
    return out
