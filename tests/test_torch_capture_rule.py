"""When a staged function captures a key (``serve/staged.py``,
:class:`CaptureRule` through ``_Staged._run``), on the CPU with injected
clocks.

Each of the engine's three staged functions runs on the CPU with its
device set to ``cuda`` after construction, a capture that makes a graph
whose replay runs the step, and one fake clock for the host and the
device: an eager call advances it by its key's eager seconds, a replay by
its replay seconds and a capture by the capture's.  The rule then sees
the timings it would read from CUDA events on the card, and each case
fixes the mode of every call: the first capture at the second call of
the first key called twice, whatever it saves; no capture of a key that
saves nothing; a capture at the call where a key's summed saving
reaches the measured capture cost; the saving scaled to the key's own
eager seconds; a dropped graph bought again by what its key lost.
Every case also holds the counters to the calls:
``eager_calls`` the eager calls, ``captures`` the captures, ``replays``
the replays with each capture's own, so that eager calls, captures and
the replays outside a capture sum to the calls, and ``eager_repeats``
the eager calls of a key called before.
"""

import pytest
import torch

import repro_torch.serve.staged as staged_mod
from repro_torch.serve.staged import (CaptureRule, StagedPrefill,
                                      StagedSlots, StagedStep, _Graph)


class _Clock:
    """One fake clock: the host clock a capture is timed by, and a timer
    with the interface of the CUDA events' (``start``, ``stop``,
    ``seconds``) that reads it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def start(self) -> float:
        return self.t

    def stop(self, t0: float) -> float:
        return self.t - t0

    @staticmethod
    def seconds(handle: float) -> float:
        return handle


class _Graph_:
    """A graph whose replay runs the step in replay time."""

    def __init__(self, fake, key, run, output):
        self.fake, self.key, self.run, self.output = fake, key, run, output

    def replay(self):
        self.fake.replaying = True
        try:
            self.output.copy_(self.run())
        finally:
            self.fake.replaying = False


class _Fake:
    """A step, its capture and its clock: seconds by key for an eager
    call (``eager``) and a replay (``replay``), and ``capture`` for a
    capture."""

    def __init__(self, eager, replay, capture):
        self.eager, self.replay, self.capture = eager, replay, capture
        self.clock = _Clock()
        self.replaying = False

    def advance(self, key):
        self.clock.t += (self.replay if self.replaying else self.eager)[key]

    def install(self, st, monkeypatch, key_of):
        fake = self

        def capture(self_, args):
            fake.clock.t += fake.capture
            key = key_of(args)
            run = lambda: self_._output(self_.step(*args))
            output = run().clone()
            fake.clock.t -= fake.eager[key]          # the capture ran none
            self_.captures += 1
            return _Graph(_Graph_(fake, key, run, output), output, {}, {})

        monkeypatch.setattr(staged_mod._Staged, "_capture", capture)
        st.device = torch.device("cuda")
        st.timer = self.clock
        st.host_clock = self.clock


def _prefill(fake, monkeypatch):
    def step(params, batch, cache):
        S = batch["tokens"].shape[-1]
        fake.advance(S)
        return batch["tokens"].float().sum(-1, keepdim=True) * params["w"], \
            cache

    st = StagedPrefill(step, lambda: {"k": torch.zeros(4)}, max_seq_len=8,
                       device="cpu")
    fake.install(st, monkeypatch, lambda args: args[1]["tokens"].shape[-1])
    params = {"w": torch.ones(1)}
    return st, lambda k: st(params, torch.arange(k, dtype=torch.int32)[None])


def _step(fake, monkeypatch):
    def step(params, pool, page_table, lengths, token):
        fake.advance(token.shape[0])
        return token.float() * params["w"], pool

    st = StagedStep(step, slots=4, max_pages=2, page_shape=(3,),
                    dtype=torch.float32, min_pages=2, device="cpu")
    st.rows(2)                  # the pool buffer, made on the CPU
    fake.install(st, monkeypatch, lambda args: args[-1].shape[0])
    params = {"w": torch.ones(1)}
    return st, lambda B: st(params, st.rows(2),
                            torch.zeros((B, 2), dtype=torch.int32),
                            torch.ones(B, dtype=torch.int32),
                            torch.ones((B, 1), dtype=torch.int32))


def _slots(fake, monkeypatch):
    def step(params, cache, token):
        fake.advance(int(cache["slot"]))
        return token.float() * params["w"], cache

    st = StagedSlots(step, lambda: {"slot": torch.zeros(())}, device="cpu")
    for slot in range(1, 5):
        st.seat(slot, {"slot": torch.tensor(float(slot))})
    fake.install(st, monkeypatch, lambda args: int(args[1]["slot"]))
    params = {"w": torch.ones(1)}
    return st, lambda slot: st(params, slot,
                               torch.ones((1, 1), dtype=torch.int32))


#: (keys called in order; eager and replay seconds by key; capture
#: seconds; the mode of each call).  Keys 1-4 are a prompt length, a
#: batch size or a slot.  A capture's cost as the rule measures it is the
#: capture's seconds and its own replay's.
E, C, R = "eager", "capture", "replay"
CASES = {
    # the function's first capture comes at the second call of the first
    # key called twice, though the key saves nothing by it
    "first_capture_at_second_call": (
        [1, 2, 1, 2, 1], {1: 0.01, 2: 0.01}, {1: 0.01, 2: 0.01}, 0.09,
        [E, E, C, E, R]),
    # a replay saves nothing against an eager call: after the first
    # capture, another key is never captured in 50 calls
    "no_saving_never_captured": (
        [1, 1, 1] + [2] * 50, {1: 0.05, 2: 0.05}, {1: 0.05, 2: 0.05}, 0.09,
        [E, C, R] + [E] * 50),
    # a capture costs 0.09 + 0.01 s; a replay saves 80 % of an eager
    # call, 0.04 s of key 2's 0.05: 0.08 s lost after two eager calls,
    # 0.12 after three, so key 2's fourth call captures
    "captured_where_saving_reaches_cost": (
        [1, 1, 1, 2, 2, 2, 2, 2], {1: 0.05, 2: 0.05}, {1: 0.01, 2: 0.01},
        0.09, [E, C, R, E, E, E, C, R]),
    # the saving scales with the key's own eager seconds: key 3's eager
    # call takes 0.2 s, 0.16 lost against a replay, past the 0.1 s cost
    # at once; key 2 at 0.05 s has lost 0.04
    "saving_scaled_to_the_key": (
        [1, 1, 1, 2, 3, 2, 3, 3], {1: 0.05, 2: 0.05, 3: 0.2},
        {1: 0.01, 2: 0.01, 3: 0.04}, 0.09, [E, C, R, E, E, E, C, R]),
    # the share a replay saves comes from every key timed both ways: key
    # 2 is bought at its third call (0.12 s lost, past the 0.1 s cost),
    # its replay takes 0.04 s, and key 4 then saves 60 % (replays 0.05
    # s over eager calls 0.125): 0.03 s lost after one call, under the
    # mean cost, now (0.1 + 0.13) / 2
    "share_of_every_key_timed_both_ways": (
        [1, 1, 1, 2, 2, 2, 2, 4, 4],
        {1: 0.05, 2: 0.075, 4: 0.05}, {1: 0.01, 2: 0.04, 4: 0.01}, 0.09,
        [E, C, R, E, E, C, R, E, E]),
}


def _recording(st) -> list:
    """The mode of each of ``st``'s calls from now on, in order."""
    modes, run = [], st._run

    def recorded(*args):
        out = run(*args)
        modes.append(out[1])
        return out

    st._run = recorded
    return modes


@pytest.mark.parametrize("make", [_prefill, _step, _slots],
                         ids=["prefill", "step", "slot"])
@pytest.mark.parametrize("case", list(CASES))
def test_capture_rule(monkeypatch, case, make):
    keys, eager, replay, capture, want = CASES[case]
    fake = _Fake(eager, replay, capture)
    st, call = make(fake, monkeypatch)
    modes = _recording(st)
    seen = {}
    repeats = 0
    for k in keys:
        seen[k] = seen.get(k, 0) + 1
        call(k)
        repeats += seen[k] > 1 and modes[-1] == E
    assert modes == want
    stats = st.stats()
    assert stats["calls"] == seen
    assert stats["eager_calls"] == modes.count(E)
    assert stats["captures"] == modes.count(C)
    assert stats["replays"] == modes.count(R) + modes.count(C)
    assert stats["eager_calls"] + stats["captures"] + \
        (stats["replays"] - stats["captures"]) == sum(seen.values())
    assert stats["eager_repeats"] == repeats


def test_a_dropped_graph_is_bought_again_by_what_its_key_lost(monkeypatch):
    """A pool-buffer regrowth drops the step's graphs.  A batch size the
    rule bought has lost past the cost already and is captured again at
    its next call; the first capture's batch size, bought at its second
    call, is captured again once its eager calls have lost the cost
    against its own timed replays."""
    fake = _Fake({2: 0.05, 3: 0.05}, {2: 0.01, 3: 0.01}, 0.09)
    st, call = _step(fake, monkeypatch)
    modes = _recording(st)
    for B in (2, 2, 2, 3, 3, 3, 3, 3):
        call(B)
    assert modes == [E, C, R, E, E, E, C, R]
    st.device = torch.device("cpu")
    st.rows(5)                          # regrows: every graph dropped
    st.device = torch.device("cuda")
    assert not st.graphs and st.regrowths == 2
    modes.clear()
    for B in (3, 2, 2, 2, 2, 3):
        call(B)
    assert modes == [C, E, E, C, R, R]
    assert st.stats()["eager_repeats"] == 4


def test_the_rule_fed_timings():
    """:class:`CaptureRule` alone: no first call captures; the first
    capture comes at a second call; after it a key with no timed eager
    call, or with no key timed both ways, is not captured; a key is
    captured once its eager calls have lost the mean capture cost."""
    rule = CaptureRule()
    assert not rule.capture("a", 1) and rule.capture("a", 2)
    rule.bought(0.1)
    rule.timed("b", "eager", 0.05)
    assert rule.lost("b") is None and not rule.capture("b", 9)
    rule.timed("a", "eager", 0.05)
    rule.timed("a", "replay", 0.01)
    assert rule.lost("c") is None and not rule.capture("c", 9)
    assert rule.lost("b") == pytest.approx(0.04)
    assert not rule.capture("b", 2)
    rule.timed("b", "eager", 0.05)
    rule.timed("b", "eager", 0.05)
    assert rule.capture("b", 4)
    assert not rule.capture("b", 1)


def test_unfinished_timings_wait_for_a_later_call():
    """A call the device has not finished (its timer reads None) is kept
    for a later call, not handed to the rule."""
    pending = [0.07]

    class _Slow(_Clock):
        def seconds(self, handle):
            return None if handle in pending else handle

    st = StagedPrefill(lambda p, b, c: (b["tokens"].float(), c),
                       lambda: {"k": torch.zeros(4)}, max_seq_len=8,
                       device="cpu")
    st.timer = _Slow()
    st._timing = [(1, "eager", 0.05), (1, "eager", 0.07)]
    st._read_timing()
    assert st._timing == [(1, "eager", 0.07)]
    assert st.rule._eager == {1: [0.05, 1]}
    pending.clear()
    st._read_timing()
    assert st._timing == [] and st.rule._eager == {
        1: [pytest.approx(0.12), 2]}
