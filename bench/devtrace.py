"""Read the device trace of the traced rounds (``torch.profiler``, CUPTI).

A traced run profiles a few rounds of the mix after the window closes (the
profiler's first step is its warm-up and is discarded, since a trace's
first operations can be lost while the tracer starts).  From the device
operations of the active rounds this reads:

* ``busy_s``: seconds in which some operation (kernel, copy, fill) ran on
  the card, overlaps counted once;
* each kernel's device seconds by name (the rooflines' denominators);
* the longest device operations by name, and the card's idle seconds by
  what the host was doing then: the innermost of the benchmark's layer
  spans (``bench.*`` ``record_function`` ranges) around each idle gap's
  midpoint (``round`` is the engine's own work in a step), or ``driver``
  outside every step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def device_ops(prof) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of every device operation, by start."""
    import torch
    out = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.name.startswith(("ProfilerStep", "bench.")):
            continue                  # a host range's shadow on the card
        name = e.name.split(" (")[0] if e.name.startswith(
            ("Memset", "Memcpy")) else e.name
        out.append((name, e.time_range.start, e.time_range.end))
    out.sort(key=lambda o: o[1])
    return out


def host_spans(prof) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of the benchmark's ``bench.*`` ranges."""
    import torch
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.name.startswith("bench.")), key=lambda s: s[1])


def step_window(prof) -> Optional[Tuple[float, float]]:
    """The host span (us) of the profiled steps (``ProfilerStep#n``)."""
    import torch
    steps = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.name.startswith("ProfilerStep")]
    if not steps:
        return None
    return (min(e.time_range.start for e in steps),
            max(e.time_range.end for e in steps))


def busy_seconds(ops: List[Tuple[str, float, float]]) -> float:
    busy, cur_s, cur_e = 0.0, None, None
    for _, s, e in ops:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-6


def kernel_seconds(ops) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, s, e in ops:
        out[name] = out.get(name, 0.0) + (e - s) * 1e-6
    return out


def _label(spans, t: float) -> str:
    best = None
    for name, s, e in spans:
        if s <= t <= e and (best is None or s >= best[1]):
            best = (name, s)
        if s > t:
            break
    return best[0][len("bench."):] if best else "driver"


def idle_by_host(ops, spans, window: Optional[Tuple[float, float]] = None
                 ) -> Dict[str, float]:
    """Idle seconds of the card between its operations (and, given the
    traced window's host span in us, before the first and after the last),
    by the host span around each gap's midpoint."""
    gaps = []
    last = window[0] if window else None
    for _, s, e in ops:
        if last is not None and s > last:
            gaps.append((last, s))
        last = e if last is None else max(last, e)
    if window and last is not None and window[1] > last:
        gaps.append((last, window[1]))
    out: Dict[str, float] = {}
    for a, b in gaps:
        lab = _label(spans, 0.5 * (a + b))
        out[lab] = out.get(lab, 0.0) + (b - a) * 1e-6
    return out


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
