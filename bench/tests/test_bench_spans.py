"""``bench.spans`` on synthetic records: the three per-layer numbers from
the program's spans (and ``None`` where there is nothing to read), the
spans shared out to rounds, and the idle gaps labelled by the bench range
and the program range around them."""

import pytest

from bench import devtrace, spans


def _span(i, name, t0, dur, parent=None, **args):
    return {"name": name, "t0": t0, "dur": dur, "id": i, "parent": parent,
            "args": args}


def _record(rounds, phase="window"):
    return {"rounds": [{"phase": phase, "wall": 1.0, "layers": {},
                        "prefills": [], "contexts": [], "spans": r}
                       for r in rounds]}


ROUNDS = [
    [_span(1, "serve.round", 0.0, 1.0),
     _span(2, "serve.prefill", 0.1, 0.3, 1, req=0, tokens=512),
     _span(3, "staged.capture", 0.1, 0.25, 2, fn="prefill", key=512),
     _span(4, "staged.replay", 0.3, 0.05, 3, fn="prefill", key=512),
     _span(5, "serve.decode", 0.5, 0.4, 1, batch=2, pages=40, pool=64),
     _span(6, "kv.decode_view", 0.5, 0.006, 5, pages=40, hits=40,
           misses=0, waves=1),
     _span(7, "staged.replay", 0.51, 0.01, 5, fn="step", key=2),
     _span(8, "kv.commit_decode", 0.6, 0.002, 5, pages=2, hits=2,
           misses=0, waves=1)],
    [_span(9, "serve.round", 1.0, 1.0),
     _span(10, "serve.prefill", 1.1, 0.2, 9, req=1, tokens=700),
     _span(11, "staged.eager", 1.1, 0.2, 10, fn="prefill", key=700),
     _span(12, "serve.prefill", 1.3, 0.1, 9, req=2, tokens=512),
     _span(13, "staged.replay", 1.3, 0.1, 12, fn="prefill", key=512),
     _span(14, "kv.decode_view", 1.5, 0.004, 9, pages=60),
     _span(15, "kv.commit_decode", 1.6, 0.002, 9, pages=2)],
]


def test_prefill_capture_ms_counts_the_capture_less_its_replay():
    # 0.25 s captured less its 0.05 s replay, over two rounds
    assert spans.prefill_capture_ms(_record(ROUNDS)) == pytest.approx(100.0)
    assert spans.prefill_capture_ms(_record(ROUNDS[1:])) == 0.0


def test_prefill_replay_share_counts_calls_not_the_replay_in_a_capture():
    # calls: capture (its replay is part of it), eager, replay
    assert spans.prefill_replay_share(_record(ROUNDS)) == \
        pytest.approx(100.0 / 3)
    only_steps = [[s for s in r if s["args"].get("fn") != "prefill"]
                  for r in ROUNDS]
    assert spans.prefill_replay_share(_record(only_steps)) is None


def test_decode_view_us_per_page():
    assert spans.decode_view_us_per_page(_record(ROUNDS)) == \
        pytest.approx(1e6 * (0.006 + 0.002 + 0.004 + 0.002) / 100)
    no_view = [[s for s in r if not s["name"].startswith("kv.")]
               for r in ROUNDS]
    assert spans.decode_view_us_per_page(_record(no_view)) is None


@pytest.mark.parametrize("read", [spans.prefill_capture_ms,
                                  spans.prefill_replay_share,
                                  spans.decode_view_us_per_page])
def test_readers_find_nothing_without_spans_or_window(read):
    """A program that records no spans (rounds without ``spans``), or a
    record without window rounds, reads ``None`` and does not raise."""
    bare = _record(ROUNDS)
    for r in bare["rounds"]:
        del r["spans"]
    assert read(bare) is None
    assert read(_record(ROUNDS, phase="after")) is None
    assert read({"rounds": []}) is None


def test_spans_go_to_the_round_they_began_in():
    class S:
        def __init__(self, name, t0, dur):
            self.name, self.t0, self.dur = name, t0, dur
            self.span_id, self.parent_id, self.args = 1, None, {"a": 1}

    got = spans.as_dicts([S("a", 0.5, 0.1), S("b", 2.5, 0.1),
                          S("c", 1.5, 0.2)], epoch=100.0)
    assert got[0] == {"name": "a", "t0": 100.5, "dur": 0.1, "id": 1,
                      "parent": None, "args": {"a": 1}}
    rounds = spans.by_round(got, [(100.0, 101.0), (101.0, 102.0),
                                  (102.0, 102.2), (102.2, 103.0)])
    assert [[s["name"] for s in r] for r in rounds] == [["a"], ["c"], [],
                                                        ["b"]]


def test_idle_labels_name_the_program_range_inside_the_bench_range():
    """Cutting each label at ``/`` gives the harness's label, and the
    seconds by harness label are the harness's."""
    ops = [("k", 0.0, 10.0), ("k", 20.0, 30.0), ("k", 50.0, 60.0),
           ("k", 90.0, 95.0)]
    bench = [("bench.round", 0.0, 100.0), ("bench.prefill", 10.0, 55.0)]
    program = [("serve.round", 0.0, 100.0), ("serve.admit", 5.0, 58.0),
               ("serve.prefill", 10.0, 55.0),
               ("staged.capture", 12.0, 19.0),
               ("staged.eager", 31.0, 49.0)]
    window = (0.0, 100.0)
    got = spans.idle_by_host(ops, bench, program, window)
    assert got == pytest.approx({"prefill/staged.capture": 10e-6,
                                 "prefill/staged.eager": 20e-6,
                                 "round/serve.round": 35e-6})
    old = devtrace.idle_by_host(ops, bench, window)
    cut = {}
    for k, v in got.items():
        cut[k.split("/")[0]] = cut.get(k.split("/")[0], 0.0) + v
    assert cut == pytest.approx(old)
    # no program range: the harness's labels as they are
    assert spans.idle_by_host(ops, bench, [], window) == \
        pytest.approx(old)


def test_program_shadows_leave_the_device_operations():
    ops = [("serve.round", 0.0, 100.0), ("gemm", 1.0, 2.0),
           ("staged.replay", 3.0, 9.0), ("Memcpy HtoD", 4.0, 5.0)]
    assert spans.without_program(ops) == [("gemm", 1.0, 2.0),
                                          ("Memcpy HtoD", 4.0, 5.0)]
