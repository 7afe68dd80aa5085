"""Read the program's own spans (``repro_torch.obs.trace``) round by round.

With ``trace: true`` in a configuration's ``engine`` section the program
records spans inside each serving round (``serve.admit``,
``serve.prefill``, ``staged.eager|capture|replay``, ``kv.decode_view``,
...), each, while a profiler records, also a ``torch.profiler`` range of
its name.  This module holds what a traced run reads from them:

* :func:`as_dicts` and :func:`by_round` turn the tracer's spans into plain
  dicts on the host clock (``name``, ``t0`` and ``dur`` in seconds,
  ``id``, ``parent``, ``args``) and share them out to the rounds whose
  host interval holds their start, as a round record's ``spans``;
* three per-layer numbers over the window's rounds of a record
  (``bench.record``) whose rounds carry ``spans``:
  :func:`prefill_capture_ms`, :func:`prefill_replay_share` and
  :func:`decode_view_us_per_page`, each ``None`` where there is nothing
  to read (a program without these spans, or no window round);
* :func:`idle_by_host`: the card's idle seconds labelled by the innermost
  ``bench.*`` range around each gap (``bench.devtrace``'s label) and the
  innermost program range there, as ``prefill/staged.capture``; cutting a
  label at ``/`` gives ``bench.devtrace``'s.  :func:`program_ranges` reads
  the program's ranges from a profile, and :func:`without_program` drops
  their shadows on the card (the profiler lays each range over the
  kernels it launched) from the device operations, which would otherwise
  count as busy time.

The harness's run (``bench.run``) does not build the program with
``trace: true`` yet, so no accepted metric reads these: they are the
definitions a traced run takes once it hands its rounds' spans to the
readers.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from bench import devtrace
from bench.record import window_rounds

#: name prefixes of the program's spans that are profiler ranges
PROGRAM = ("serve.", "staged.", "kv.", "exec.", "fault.")


def as_dicts(spans: Iterable, epoch: float) -> List[dict]:
    """The tracer's ``Span`` objects as dicts, ``t0`` on the host clock
    (``time.monotonic``, the clock ``bench.driver.serve`` times rounds
    on)."""
    return [{"name": s.name, "t0": epoch + s.t0, "dur": s.dur,
             "id": s.span_id, "parent": s.parent_id, "args": dict(s.args)}
            for s in spans]


def by_round(spans: Sequence[dict], bounds: Sequence[Tuple[float, float]]
             ) -> List[List[dict]]:
    """For each round's host interval ``(start, end)``, the spans that
    began in it (spans sorted by ``t0``, intervals in order)."""
    spans = sorted(spans, key=lambda s: s["t0"])
    out, i = [], 0
    for start, end in bounds:
        while i < len(spans) and spans[i]["t0"] < start:
            i += 1
        j = i
        while j < len(spans) and spans[j]["t0"] <= end:
            j += 1
        out.append(spans[i:j])
        i = j
    return out


def _window_spans(rec: dict) -> Optional[List[List[dict]]]:
    rounds = window_rounds(rec)
    if not rounds or any("spans" not in r for r in rounds):
        return None
    return [r["spans"] for r in rounds]


def _prefill_calls(spans: List[dict]) -> List[dict]:
    """The staged prefill calls: ``staged.*`` spans of ``fn`` prefill
    that no other staged span holds (a capture's replay is its child)."""
    staged = {s["id"] for s in spans if s["name"].startswith("staged.")}
    return [s for s in spans if s["name"] in (
        "staged.eager", "staged.capture", "staged.replay")
        and s["args"].get("fn") == "prefill"
        and s["parent"] not in staged]


def prefill_capture_ms(rec: dict) -> Optional[float]:
    """Host milliseconds a window round spends capturing prefill graphs:
    ``staged.capture`` spans of ``fn`` prefill, less the replay inside
    each (the card runs nothing of the call while it captures)."""
    rounds = _window_spans(rec)
    if rounds is None:
        return None
    total = 0.0
    for spans in rounds:
        for s in spans:
            if s["name"] != "staged.capture" \
                    or s["args"].get("fn") != "prefill":
                continue
            total += s["dur"] - sum(c["dur"] for c in spans
                                    if c["parent"] == s["id"]
                                    and c["name"] == "staged.replay")
    return 1e3 * total / len(rounds)


def prefill_replay_share(rec: dict) -> Optional[float]:
    """The share, in %, of the window's prefill calls that replayed a
    graph (``staged.replay``; the others ran eagerly or captured)."""
    rounds = _window_spans(rec)
    if rounds is None:
        return None
    calls = [s for spans in rounds for s in _prefill_calls(spans)]
    if not calls:
        return None
    return 100.0 * sum(s["name"] == "staged.replay" for s in calls) \
        / len(calls)


def decode_view_us_per_page(rec: dict) -> Optional[float]:
    """Host microseconds in ``kv.decode_view`` and ``kv.commit_decode``
    over the window, per page of the rounds' views (their unions)."""
    rounds = _window_spans(rec)
    if rounds is None:
        return None
    secs = sum(s["dur"] for spans in rounds for s in spans
               if s["name"] in ("kv.decode_view", "kv.commit_decode"))
    pages = sum(s["args"].get("pages", 0) for spans in rounds
                for s in spans if s["name"] == "kv.decode_view")
    if pages <= 0:
        return None
    return 1e6 * secs / pages


def program_ranges(prof, prefixes: Tuple[str, ...] = PROGRAM
                   ) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of the program's ranges on the host."""
    import torch
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.name.startswith(prefixes)), key=lambda s: s[1])


def without_program(ops, prefixes: Tuple[str, ...] = PROGRAM):
    """``bench.devtrace.device_ops`` less the program ranges' shadows."""
    return [o for o in ops if not o[0].startswith(prefixes)]


def _innermost(spans, t: float) -> Optional[str]:
    best = None
    for name, s, e in spans:
        if s > t:
            break
        if t <= e and (best is None or s >= best[1]):
            best = (name, s)
    return best[0] if best else None


def idle_by_host(ops, bench_spans, program: Sequence[Tuple[str, float,
                                                           float]],
                 window: Optional[Tuple[float, float]] = None
                 ) -> Dict[str, float]:
    """``bench.devtrace.idle_by_host``, each label followed by ``/`` and
    the innermost program range around the gap's midpoint, where there is
    one."""
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
        mid = 0.5 * (a + b)
        lab = devtrace._label(bench_spans, mid)
        inner = _innermost(program, mid)
        if inner is not None:
            lab += "/" + inner
        out[lab] = out.get(lab, 0.0) + (b - a) * 1e-6
    return out
