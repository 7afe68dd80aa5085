"""Trace exporters: Chrome trace-event JSON and JSONL round-trip.

Chrome format (the ``chrome://tracing`` / Perfetto "JSON object
format"): one ``"X"`` (complete) event per span with ``ts``/``dur`` in
microseconds, plus ``"M"`` metadata events naming the tracks.  Track
layout:

  * pid ``1`` ("fabric links") — one tid (thread row) per expander id;
    every span tagged with an expander lands here.
  * pid ``2`` ("tenants") — one tid per tenant name; every span tagged
    with a tenant lands here.  A span carrying both tags is emitted on
    *both* tracks (same ``id`` in args), which is what makes the
    per-link and per-tenant views each complete in Perfetto.
  * pid ``3`` ("failure domains") — one tid per rack failure domain;
    every span whose args carry a ``domain`` tag (rack-topology-aware
    link transfers) also lands here, giving the blast-radius view.
  * pid ``0`` ("engine") — spans with none of the tags (serve rounds,
    migration rounds, ...).

Every event's ``args`` carries the full structured span (op class,
nbytes, tenant, expander, span id, parent, dur in seconds, plus any
emitter extras), so the Chrome JSON is *parseable back into spans* —
``load_trace`` accepts either format and ``tools/lmbtrace.py`` never
needs the JSONL twin to exist.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional

from repro_torch.obs.trace import Span

_PID_ENGINE = 0
_PID_LINKS = 1
_PID_TENANTS = 2
_PID_DOMAINS = 3


def _span_args(s: Span) -> Dict[str, Any]:
    a = {"id": s.span_id, "op": s.op, "nbytes": s.nbytes,
         "dur_s": s.dur, "t0_s": s.t0}
    if s.parent_id is not None:
        a["parent"] = s.parent_id
    if s.tenant is not None:
        a["tenant"] = s.tenant
    if s.expander is not None:
        a["expander"] = s.expander
    a.update(s.args)
    return a


def chrome_trace_events(spans: Iterable[Span]) -> List[Dict[str, Any]]:
    """Spans -> list of Chrome trace-event dicts (with track metadata)."""
    events: List[Dict[str, Any]] = []
    tenants: Dict[str, int] = {}
    domains: Dict[str, int] = {}
    expanders: set = set()

    def emit(s: Span, pid: int, tid: int) -> None:
        events.append({
            "name": s.name, "ph": "X", "pid": pid, "tid": tid,
            "ts": s.t0 * 1e6, "dur": s.dur * 1e6,
            "cat": s.op or "span", "args": _span_args(s),
        })

    for s in spans:
        placed = False
        if s.expander is not None:
            expanders.add(s.expander)
            emit(s, _PID_LINKS, int(s.expander))
            placed = True
        if s.tenant is not None:
            tid = tenants.setdefault(s.tenant, len(tenants))
            emit(s, _PID_TENANTS, tid)
            placed = True
        dom = s.args.get("domain")
        if dom is not None:
            tid = domains.setdefault(str(dom), len(domains))
            emit(s, _PID_DOMAINS, tid)
            placed = True
        if not placed:
            emit(s, _PID_ENGINE, 0)

    meta: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": _PID_ENGINE, "tid": 0,
         "args": {"name": "engine"}},
        {"name": "process_name", "ph": "M", "pid": _PID_LINKS, "tid": 0,
         "args": {"name": "fabric links"}},
        {"name": "process_name", "ph": "M", "pid": _PID_TENANTS, "tid": 0,
         "args": {"name": "tenants"}},
        {"name": "process_name", "ph": "M", "pid": _PID_DOMAINS, "tid": 0,
         "args": {"name": "failure domains"}},
    ]
    for eid in sorted(expanders):
        meta.append({"name": "thread_name", "ph": "M", "pid": _PID_LINKS,
                     "tid": int(eid),
                     "args": {"name": f"expander {eid} link"}})
    for tenant, tid in sorted(tenants.items(), key=lambda kv: kv[1]):
        meta.append({"name": "thread_name", "ph": "M",
                     "pid": _PID_TENANTS, "tid": tid,
                     "args": {"name": f"tenant {tenant}"}})
    for dom, tid in sorted(domains.items(), key=lambda kv: kv[1]):
        meta.append({"name": "thread_name", "ph": "M",
                     "pid": _PID_DOMAINS, "tid": tid,
                     "args": {"name": f"domain {dom}"}})
    return meta + events


def write_chrome_trace(spans: Iterable[Span], path: str,
                       extra: Optional[Dict[str, Any]] = None) -> None:
    payload = {"traceEvents": chrome_trace_events(spans),
               "displayTimeUnit": "ms",
               "otherData": {"generator": "repro_torch.obs", **(extra or {})}}
    with open(path, "w") as f:
        json.dump(payload, f)


# -- JSONL ---------------------------------------------------------
def span_to_dict(s: Span) -> Dict[str, Any]:
    return {"name": s.name, "t0": s.t0, "dur": s.dur, "op": s.op,
            "tenant": s.tenant, "expander": s.expander,
            "nbytes": s.nbytes, "span_id": s.span_id,
            "parent_id": s.parent_id, "args": s.args}


def span_from_dict(d: Dict[str, Any]) -> Span:
    return Span(name=d["name"], t0=d["t0"], dur=d["dur"],
                op=d.get("op", ""), tenant=d.get("tenant"),
                expander=d.get("expander"), nbytes=d.get("nbytes", 0),
                span_id=d.get("span_id", 0),
                parent_id=d.get("parent_id"), args=d.get("args", {}))


def write_jsonl(spans: Iterable[Span], path: str) -> None:
    with open(path, "w") as f:
        for s in spans:
            f.write(json.dumps(span_to_dict(s)) + "\n")


def read_jsonl(path: str) -> List[Span]:
    out: List[Span] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(span_from_dict(json.loads(line)))
    return out


def _span_from_chrome(ev: Dict[str, Any]) -> Span:
    a = dict(ev.get("args", {}))
    sid = a.pop("id", 0)
    extras = {k: v for k, v in a.items()
              if k not in ("op", "nbytes", "dur_s", "t0_s", "parent",
                           "tenant", "expander")}
    return Span(name=ev["name"], t0=a.get("t0_s", ev["ts"] / 1e6),
                dur=a.get("dur_s", ev.get("dur", 0.0) / 1e6),
                op=a.get("op", ev.get("cat", "")),
                tenant=a.get("tenant"), expander=a.get("expander"),
                nbytes=a.get("nbytes", 0), span_id=sid,
                parent_id=a.get("parent"), args=extras)


def load_trace(path: str) -> List[Span]:
    """Load spans from either export format (sniffed by content).

    Chrome traces deduplicate by span id (a tenant+expander span is
    emitted on two tracks but is one logical span).
    """
    with open(path) as f:
        head = f.read(1)
        f.seek(0)
        if head != "{":
            return read_jsonl(path)
        first = f.readline()
        try:
            doc = json.loads(first)
            # single-line JSONL file whose first record parsed fine
            if "traceEvents" not in doc:
                return read_jsonl(path)
        except json.JSONDecodeError:
            f.seek(0)
            doc = json.load(f)
    if "traceEvents" not in doc:
        raise ValueError(f"{path}: not a trace file")
    seen: Dict[int, Span] = {}
    anon: List[Span] = []
    for ev in doc["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        s = _span_from_chrome(ev)
        if s.span_id:
            seen.setdefault(s.span_id, s)
        else:
            anon.append(s)
    return sorted(seen.values(), key=lambda s: (s.t0, s.span_id)) + anon
