"""The window's arithmetic on hand-worked stamps: tokens and gaps in the
window, TTFT from due instants, censored and failed requests."""

import pytest

from bench import tails
from bench.tails import Stamped


def test_tokens_gaps_and_ttft_by_hand():
    reqs = [
        Stamped(due=0.5, tokens=[1.5, 2.0, 3.0]),   # due before the window
        Stamped(due=1.0, tokens=[2.5, 3.5, 5.5]),   # last token after it
        Stamped(due=4.0, tokens=[]),                # censored at 5 - 4
        Stamped(due=2.0, tokens=[4.0], failed=True),
        Stamped(due=5.0, tokens=[5.2]),             # due at the end: out
    ]
    start, end = 1.0, 5.0
    assert tails.window_tokens(reqs, start, end) == 6
    assert sorted(tails.window_gaps(reqs, start, end)) == [0.5, 1.0, 1.0]
    t = tails.window_ttfts(reqs, start, end)
    assert sorted(t["samples"]) == [1.0, 1.5, 3.0]
    assert (t["censored"], t["failed"]) == (1, 1)
    s = tails.summary(reqs, start, end)
    assert s["tokens_per_s"] == pytest.approx(6 / 4.0)
    assert s["itl_p95_ms"] == pytest.approx(1000.0)
    assert s["ttft_p95_ms"] == pytest.approx(1e3 * (1.5 + 0.9 * 1.5))


def test_due_counts_the_wait():
    """A request its client sent at 1.0 but the engine seated later is
    timed from 1.0."""
    r = Stamped(due=1.0, tokens=[1.8, 1.9])
    t = tails.window_ttfts([r], 0.0, 2.0)
    assert t["samples"] == [pytest.approx(0.8)]


def test_percentile_is_linear_between_order_statistics():
    assert tails.percentile([1, 2, 3, 4], 50) == 2.5
    assert tails.percentile([0, 10], 95) == pytest.approx(9.5)
    with pytest.raises(ValueError):
        tails.percentile([], 50)
