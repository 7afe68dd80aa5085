"""The port's serving path traced (``repro_torch.obs.trace``), on the CPU
at a reduced size.

* One engine run's span tree: the round's phases (``serve.admit``,
  ``serve.prefill``, ``serve.decode``, ``serve.readback``,
  ``serve.tail``), each staged call's mode, the KV store's batched
  accesses, the request ids spans and events share, and staged spans
  counted as the staged counters count.
* Capture and replay spans, with the graph faked on the CPU (a CPU run
  has no graph to capture).
* Tracing off: no ``Span``, no lock, no profiler range; the served tokens
  are those of a traced run.
* Under ``torch.profiler`` (CPU activity) every span is a profiler range
  of its name, nested as in the ring, about as long; a span recorded with
  ``add`` never is one, and a modeled one (``link.xfer``) is marked and
  gets a Chrome track of its own.
* The LMB tier's burst timing: two stamps bracket each burst's copies on
  its copy stream (the recording stand-in of ``stream_recorder.py``), and
  the span's ``link_s`` and ``gb_per_s`` are filled only at ``settle()``
  or when the spans are read, never with a wait on the path that made
  them.
"""

import json
import re
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import TierExecutor, offload, system_for
from repro_torch.core.buffer import LinkedBuffer
from repro_torch.core.metrics import GLOBAL_METRICS
from repro_torch.models import build_model
from repro_torch.models.flags import Flags
from repro_torch.obs import trace as trace_mod
from repro_torch.obs.export import chrome_trace_events, load_trace, \
    write_chrome_trace
from repro_torch.obs.trace import GLOBAL_TRACER, SpanTracer
from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec
from repro_torch.serve import staged as staged_mod
from repro_torch.serve.staged import (StagedPrefill, StagedSlots,
                                      StagedStep, _Graph)
from stream_recorder import Recorder, before

LENGTHS = (5, 13, 20, 9, 13, 17)

#: the spans the serving path opens with ``span()`` (profiler ranges)
RANGED = {"serve.round", "serve.admit", "serve.prefill", "serve.decode",
          "serve.readback", "serve.tail", "staged.eager", "kv.decode_view",
          "kv.commit_decode", "exec.read_pages", "exec.write_pages",
          "fault.batch"}
#: what it records with ``add`` or ``event`` (never ranges)
ADDED = {"ttft", "token", "fault", "evict.batch", "prefetch.burst",
         "link.xfer", "host.meter.burst", "prefetch.defer", "staged.regrow",
         "overlap.admit"}


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    GLOBAL_METRICS.reset()
    yield


@pytest.fixture(scope="module")
def model_params():
    model = build_model(get_config("qwen2-1.5b").reduced(),
                        Flags(remat=False), device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _engine(model_params, *, trace, onboard=8):
    model, params = model_params
    eng = ServeEngine(
        model, params, system_for("dev0", pool_gib=1, page_bytes=4096),
        EngineConfig(decode_slots=4, max_seq_len=64, page_tokens=8,
                     onboard_pages=onboard, trace=trace, round_time_s=1e-3),
        device_id="dev0", device="cpu")
    rng = np.random.default_rng(3)
    rids = [eng.submit(SubmitSpec(prompt=rng.integers(0, 100, n).astype(
        np.int32), max_new_tokens=4)) for n in LENGTHS]
    return eng, rids


def _serve(model_params, *, trace, onboard=8):
    eng, rids = _engine(model_params, trace=trace, onboard=onboard)
    steps = 0
    while eng.waiting or eng.active:
        eng.step()
        steps += 1
    return eng, [eng.requests[r].out_tokens for r in rids], steps


@pytest.mark.parametrize("onboard", [8, 4])
def test_round_span_tree(model_params, onboard):
    """Every phase under its round, every staged call under the prefill
    or decode that made it, the request ids of spans and events agree, and
    the staged spans count what the staged counters count."""
    eng, _, steps = _serve(model_params, trace=True, onboard=onboard)
    spans = eng.trace.spans()
    by_id = {s.span_id: s for s in spans}

    def parent(s):
        return by_id[s.parent_id].name if s.parent_id in by_id else None

    def named(name, **args):
        return [s for s in spans if s.name == name and all(
            s.args.get(k) == v for k, v in args.items())]

    assert not named("decode.paged")
    assert len(named("serve.round")) == steps
    assert {parent(s) for s in named("serve.round")} == {None}
    assert {parent(s) for s in named("serve.admit")} == {"serve.round",
                                                          "serve.tail"}
    for name in ("serve.tail", "serve.decode"):
        assert {parent(s) for s in named(name)} == {"serve.round"}
    assert {parent(s) for s in named("serve.prefill")} == {"serve.admit"}
    assert {parent(s) for s in named("serve.readback")} == {
        "serve.prefill", "serve.decode"}
    for name in ("kv.decode_view", "kv.commit_decode"):
        assert {parent(s) for s in named(name)} == {"serve.decode"}
    # one prefill per request, carrying its id and prompt length, and the
    # request's ttft event and first readback inside it
    prefills = named("serve.prefill")
    assert sorted(s.args["req"] for s in prefills) == sorted(eng.requests)
    for s in prefills:
        assert s.args["tokens"] == len(eng.requests[s.args["req"]].prompt)
        kids = [c for c in spans if c.parent_id == s.span_id]
        assert [c.args["req"] for c in kids if c.name in (
            "ttft", "serve.readback")] == [s.args["req"]] * 2
        staged = [c for c in kids if c.name.startswith("staged.")]
        assert [(c.name, c.args["fn"], c.args["key"]) for c in staged] == [
            ("staged.eager", "prefill", s.args["tokens"])]
    for s in named("token"):
        assert s.args["req"] in eng.requests
    # each paged round: its batch, the union its view read, the step
    decodes = named("serve.decode")
    assert len(decodes) == eng.paged_rounds > 0
    for s in decodes:
        kids = {c.name: c for c in spans if c.parent_id == s.span_id}
        view = kids["kv.decode_view"]
        assert view.args["pages"] == s.args["pages"] <= s.args["pool"]
        assert view.args["hits"] + view.args["misses"] == s.args["pages"]
        assert view.args["waves"] >= 1
        assert kids["kv.commit_decode"].args["pages"] == s.args["batch"]
        assert (kids["staged.eager"].args["fn"],
                kids["staged.eager"].args["key"]) == ("step",
                                                      s.args["batch"])
    if onboard == 4:     # the union outgrows the onboard tier: waves
        assert max(s.args["waves"] for s in named("kv.decode_view")) > 1
    # the staged counters, as the spans count them (no graph on the CPU)
    sp, st = eng.staged_prefill, eng.staged
    assert len(named("staged.eager", fn="prefill")) == sp.eager_prefills
    assert len(named("staged.eager", fn="step")) == st.eager_rounds
    assert sp.captures == st.captures == sp.replays == st.replays == 0
    assert not named("staged.capture") and not named("staged.replay")
    assert [(s.args["rows_from"], s.args["rows_to"])
            for s in named("staged.regrow")] == [(0, len(st.pool))]
    assert st.regrowths == 1


class _FakeGraph:
    """A CPU stand-in for a captured graph: a replay runs the step and
    copies its result into the static output."""

    def __init__(self, run, output):
        self.run, self.output = run, output

    def replay(self):
        self.output.copy_(self.run())


def _fake_capture(self, args):
    """``_Staged._capture`` on the CPU: a graph whose replay runs the step
    (no kernel counts to carry)."""
    output = self._output(self.step(*args)).clone()
    self.captures += 1
    return _Graph(_FakeGraph(lambda: self._output(self.step(*args)),
                             output), output, {}, {})


def _prefill_calls(tr):
    st = StagedPrefill(lambda p, b, c: (b["tokens"].float().sum(
        -1, keepdim=True) * p["w"], c), lambda: {"k": torch.zeros(4)},
        max_seq_len=8, device="cpu")
    st.trace = tr
    st.device = torch.device("cuda")
    params = {"w": torch.ones(1)}
    for S in (4, 4, 4, 6, 6, 7):
        st(params, torch.arange(S, dtype=torch.int32)[None])
    return st, [4, 4, 4, 6, 6, 7], st.eager_prefills


def _step_calls(tr):
    st = StagedStep(lambda p, pool, pt, n, tok: (tok.float() * p["w"], pool),
                    slots=4, max_pages=2, page_shape=(3,),
                    dtype=torch.float32, min_pages=2, device="cpu")
    st.trace = tr
    params = {"w": torch.ones(1)}
    pool = st.rows(2)
    st.device = torch.device("cuda")
    keys = [2, 2, 2, 3, 3, 1]
    for B in keys:
        st(params, pool, torch.zeros((B, 2), dtype=torch.int32),
           torch.ones(B, dtype=torch.int32),
           torch.ones((B, 1), dtype=torch.int32))
    st.device = torch.device("cpu")
    st.rows(5)           # outgrows the buffer: regrows, drops the graphs
    return st, keys, st.eager_rounds


def _slot_calls(tr):
    st = StagedSlots(lambda p, cache, tok: (tok.float() * p["w"], cache),
                     lambda: {"k": torch.zeros(2)}, device="cpu")
    st.trace = tr
    params = {"w": torch.ones(1)}
    for slot in (0, 1):
        st.seat(slot, {"k": torch.zeros(2)})
    st.device = torch.device("cuda")
    keys = [0, 0, 0, 1, 1, 0]
    for slot in keys:
        st(params, slot, torch.ones((1, 1), dtype=torch.int32))
    return st, keys, st.eager_steps


@pytest.mark.parametrize("calls", [_prefill_calls, _step_calls, _slot_calls],
                         ids=["prefill", "step", "slot"])
def test_staged_call_spans_count_as_the_counters(monkeypatch, calls):
    """A shape's first call is ``staged.eager``, its second a
    ``staged.capture`` holding the ``staged.replay`` that gives its
    result, every later one a ``staged.replay``: each mode's spans count
    what its counter counts, and carry ``fn`` and the call's key."""
    monkeypatch.setattr(staged_mod._Staged, "_capture", _fake_capture)
    tr = SpanTracer()
    st, keys, eager = calls(tr)
    spans = [s for s in tr.spans() if s.name.startswith("staged.")
             and s.name != "staged.regrow"]
    calls_ = [s for s in spans if s.parent_id is None]
    seen, want = {}, []
    for k in keys:
        seen[k] = seen.get(k, 0) + 1
        want.append((["eager", "capture"] + ["replay"] * 9)[seen[k] - 1])
    assert [(s.name[len("staged."):], s.args["key"]) for s in calls_] == \
        list(zip(want, keys))
    assert {s.args["fn"] for s in spans} == {st.FN}
    counts = {m: sum(s.name == "staged." + m for s in spans)
              for m in ("eager", "capture", "replay")}
    assert counts == {"eager": eager, "capture": st.captures,
                      "replay": st.replays}
    for cap in (s for s in spans if s.name == "staged.capture"):
        kids = [s for s in spans if s.parent_id == cap.span_id]
        assert [(s.name, s.args["key"]) for s in kids] == [
            ("staged.replay", cap.args["key"])]
    regrow = [s for s in tr.spans() if s.name == "staged.regrow"]
    if isinstance(st, StagedStep):
        assert [(s.args["rows_from"], s.args["rows_to"]) for s in regrow] \
            == [(0, 2), (2, 8)] and st.regrowths == 2
    else:
        assert not regrow


class _CountingLock:
    def __init__(self):
        self.n = 0
        self._lock = __import__("threading").Lock()

    def __enter__(self):
        self.n += 1
        return self._lock.__enter__()

    def __exit__(self, *exc):
        return self._lock.__exit__(*exc)


def test_tracing_off_makes_no_span_lock_or_range(model_params, monkeypatch):
    """With tracing off the serving path makes no ``Span``, takes no
    tracer lock and opens no profiler range.  Traced, it makes spans (in
    the engine's own tracer), opens ranges only while a profiler records,
    and serves the same tokens."""
    made = {"span": 0, "range": 0}
    real_span, real_range = trace_mod.Span, torch.profiler.record_function

    def span(*a, **kw):
        made["span"] += 1
        return real_span(*a, **kw)

    def record_function(*a, **kw):
        made["range"] += 1
        return real_range(*a, **kw)

    monkeypatch.setattr(trace_mod, "Span", span)
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    lock = _CountingLock()
    monkeypatch.setattr(GLOBAL_TRACER, "_lock", lock)
    monkeypatch.setattr(GLOBAL_TRACER, "enabled", False)
    off, tokens_off, _ = _serve(model_params, trace=False, onboard=4)
    assert off.trace is GLOBAL_TRACER
    assert made == {"span": 0, "range": 0} and lock.n == 0
    _, tokens_on, _ = _serve(model_params, trace=True, onboard=4)
    assert made["span"] > 0 and made["range"] == 0 and lock.n == 0
    assert tokens_on == tokens_off
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _, tokens_prof, _ = _serve(model_params, trace=True, onboard=4)
    assert made["range"] > 0 and lock.n == 0
    assert tokens_prof == tokens_off


def _profiled(model_params, onboard):
    """A traced engine's rounds after its first under ``torch.profiler``
    (CPU activity): ``(engine, ring spans, profiler events)``."""
    eng, _ = _engine(model_params, trace=True, onboard=onboard)
    eng.step()                   # the profiler's first range costs more
    eng.trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        while eng.waiting or eng.active:
            eng.step()
    return eng, eng.trace.spans(), [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CPU]


def test_spans_are_profiler_ranges_with_the_same_nesting(model_params):
    """Each span opened with ``span()`` is a profiler range of its name;
    a child's range lies inside its parent's, each range covers its span,
    and over each name the median range lasts what its span lasts within
    10 % or 50 us (a single pair can take a pause of the shared host).
    Nothing recorded with ``add`` or ``event`` is a range."""
    _, spans, events = _profiled(model_params, onboard=4)
    ranged = [s for s in spans if s.name in RANGED]
    assert {s.name for s in ranged} == RANGED
    assert not {s.name for s in spans} - RANGED - ADDED
    names = {s.name for s in spans}
    assert not [e for e in events if e.name in names - RANGED]
    match = {}
    for name in RANGED:
        mine = sorted((s for s in ranged if s.name == name),
                      key=lambda s: s.t0)
        theirs = sorted((e for e in events if e.name == name),
                        key=lambda e: e.time_range.start)
        assert len(mine) == len(theirs), name
        over = []
        for s, e in zip(mine, theirs):
            dur_us = e.time_range.end - e.time_range.start
            assert dur_us >= s.dur * 1e6 - 2.0, name
            over.append((dur_us - s.dur * 1e6,
                         max(0.1 * s.dur * 1e6, 50.0)))
            match[s.span_id] = e
        gap, limit = sorted(over)[len(over) // 2]
        assert gap <= limit, name
    nested = 0
    for s in ranged:
        if s.parent_id in match:
            e, p = match[s.span_id], match[s.parent_id]
            assert p.time_range.start <= e.time_range.start
            assert e.time_range.end <= p.time_range.end
            nested += 1
    assert nested > len(ranged) // 2


def test_modeled_spans_are_marked_never_ranges_with_a_track_of_their_own(
        model_params, tmp_path):
    """``link.xfer`` spans carry ``clock: modeled``, are no profiler
    range, and the Chrome export puts them on the modeled-clock track
    alone; the export loads back into the same spans."""
    eng, spans, events = _profiled(model_params, onboard=4)
    links = [s for s in spans if s.name == "link.xfer"]
    assert links and {s.args["clock"] for s in links} == {"modeled"}
    assert not [s for s in spans if s.name != "link.xfer"
                and s.args.get("clock") == "modeled"]
    assert not [e for e in events if e.name == "link.xfer"]
    chrome = chrome_trace_events(spans)
    xfers = [e for e in chrome if e["ph"] == "X" and e["name"] == "link.xfer"]
    assert len(xfers) == len(links)
    assert {e["pid"] for e in xfers} == {4}
    assert {e["name"] for e in chrome if e["ph"] == "X"
            and e["pid"] == 4} == {"link.xfer"}
    assert {"name": "process_name", "ph": "M", "pid": 4, "tid": 0,
            "args": {"name": "modeled clock"}} in chrome
    path = tmp_path / "trace.json"
    write_chrome_trace(spans, str(path))
    json.loads(path.read_text())
    back = load_trace(str(path))
    assert sorted((s.span_id, s.name, s.args.get("clock")) for s in back) \
        == sorted((s.span_id, s.name, s.args.get("clock")) for s in spans)


def _lmb_buffer(tr, streams=None):
    ex = TierExecutor("cpu", trace=tr)
    if streams is not None:
        ex.streams = streams
    return LinkedBuffer(
        name="buf", device_id="dev0",
        host=system_for("dev0", pool_gib=1, page_bytes=4096).host(),
        executor=ex, page_shape=(2, 4), dtype=torch.float32,
        onboard_pages=4, policy="lru")


def _page_through(buf):
    """Eight pages through a four-page onboard tier: write-backs (D2H)
    and faults (H2D) in bursts; returns what was written."""
    data = torch.arange(8 * 8, dtype=torch.float32).reshape(8, 2, 4)
    pages = buf.append_pages(8)
    buf.write_many(pages[:4], data[:4])
    buf.write_many(pages[4:], data[4:])
    assert torch.equal(buf.read_many(pages[:4]), data[:4])
    assert torch.equal(buf.read_many(pages[4:]), data[4:])
    return data


@pytest.mark.parametrize("resolved_by", ["settle", "spans"])
def test_burst_stamps_bracket_each_burst_on_its_copy_stream(resolved_by):
    """On the copy streams (the recorder, its pools paged) two stamps
    bracket each burst's copies on its stream; the host never waits for
    one on the paths that moved the pages, and each span of a burst gains
    ``link_s`` and ``gb_per_s`` at ``settle()`` or when the spans are
    read."""
    tr = SpanTracer()
    rec = Recorder(paged=lambda t: False)
    buf = _lmb_buffer(tr, rec)
    rec.paged = lambda t: any(t is p for p in buf._lmb_pools)
    _page_through(buf)
    copy_streams = ("h2d", "d2h")
    for s in copy_streams:
        ops = [o for o in rec.log if o["stream"] == s]
        kinds = "".join("s" if o["kind"] == "stamp" else "c" for o in ops)
        assert re.fullmatch("(sc+s)+", kinds), kinds
        # every copy lies between the two stamps of its burst
        open_ = None
        for o in ops:
            if o["kind"] == "stamp":
                open_ = o if open_ is None else None
            else:
                assert open_ is not None and before(open_, o)
    assert not [o for o in rec.log if o["kind"] == "stamp_wait"]
    timed = [s for s in tr._buf if s is not None and s.name.startswith(
        "exec.")]
    assert not [s for s in timed if "link_s" in s.args]
    if resolved_by == "settle":
        buf.executor.settle()
        spans = [s for s in tr._buf if s is not None]
    else:
        spans = tr.spans()
    bursts = [s for s in spans if "link_s" in s.args]
    stamps = [o for o in rec.log if o["kind"] == "stamp"]
    assert len(bursts) == len(stamps) // 2 > 0
    assert {s.name for s in bursts} == {"exec.read_pages",
                                        "exec.write_pages"}
    for s in bursts:
        assert s.args["link_s"] > 0
        assert s.args["gb_per_s"] == pytest.approx(
            s.nbytes / s.args["link_s"] * 1e-9)
    assert len([o for o in rec.log if o["kind"] == "stamp_wait"]) == \
        len(bursts)


def test_cpu_bursts_carry_no_link_fields():
    """On the CPU (no copy stream) a burst's span has no link fields and
    nothing is left to resolve."""
    tr = SpanTracer()
    buf = _lmb_buffer(tr)
    assert isinstance(buf.executor.streams, offload.HostStreams)
    _page_through(buf)
    spans = tr.spans()
    assert [s for s in spans if s.name.startswith("exec.")]
    assert not [s for s in spans if "link_s" in s.args
                or "gb_per_s" in s.args]
    assert not tr._deferred


def test_epoch_puts_spans_on_the_host_clock_and_defer_is_bounded():
    """``epoch + t0`` is a span's start on ``time.monotonic``; deferred
    fields resolve oldest first, without waiting until asked to, and past
    ``capacity`` pending the oldest is dropped."""
    tr = SpanTracer(capacity=3)
    a = time.monotonic()
    with tr.span("outer"):
        time.sleep(0.002)
    b = time.monotonic()
    (s,) = tr.spans()
    assert a <= tr.epoch + s.t0 <= tr.epoch + s.t0 + s.dur <= b
    landed, done = set(), []

    def resolver(i):
        def resolve(wait):
            if i not in landed and not wait:
                return False
            done.append(i)
            return True
        return resolve

    for i in range(5):
        tr.defer(resolver(i))
    assert done == [] and len(tr._deferred) == 3
    landed.update({2, 3})
    tr.resolve_deferred(wait=False)
    assert done == [2, 3]
    tr.spans()
    assert done == [2, 3, 4] and not tr._deferred
    off = SpanTracer(enabled=False)
    off.defer(resolver(9))
    assert not off._deferred
