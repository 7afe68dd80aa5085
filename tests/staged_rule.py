"""The capture rule's marks on a staged function's calls, shared by the
port's card tests of the staged engine (``serve/staged.py``,
``CaptureRule``): which call of which key ran eagerly, captured or
replayed, and the counters that must agree with them.
"""


def recording(staged) -> list:
    """Wrap ``staged._run``: the (key, mode) of each call from now on, in
    order."""
    calls, run = [], staged._run

    def recorded(key, graph_key, args):
        out = run(key, graph_key, args)
        calls.append((key, out[1]))
        return out

    staged._run = recorded
    return calls


def check_rule(calls, stats, graphs_dropped: bool = False) -> None:
    """Hold the (key, mode) ``calls`` of a fresh staged function to the
    rule and ``stats`` to the calls: each key's first call eager; the
    first key called twice captured at its second call; a key captured
    replays at every later call (unless ``graphs_dropped``: a pool move
    can take its graph); ``eager_calls``, ``captures`` and ``replays``
    (with each capture's own) count the modes; ``eager_repeats`` the
    eager calls of a key called before."""
    seen, first, captured, repeats = {}, None, set(), 0
    for key, mode in calls:
        seen[key] = seen.get(key, 0) + 1
        if seen[key] == 1:
            assert mode == "eager", (key, calls)
        elif first is None:
            first = key
            assert mode == "capture", (key, calls)
        elif key in captured and not graphs_dropped:
            assert mode == "replay", (key, calls)
        repeats += seen[key] > 1 and mode == "eager"
        if mode == "capture":
            captured.add(key)
    modes = [mode for _, mode in calls]
    assert stats["calls"] == dict(sorted(seen.items()))
    assert stats["eager_calls"] == modes.count("eager")
    assert stats["captures"] == modes.count("capture")
    assert stats["replays"] == modes.count("replay") + modes.count("capture")
    assert stats["eager_repeats"] == repeats
