"""The generator: the same seed gives the same requests; each seed draws
its own sizes from the mix's distributions, repeats and all."""

import numpy as np
import pytest

from bench import manifest
from bench import traffic as mix

MIXES = sorted({w["traffic"] for w in manifest.load()["workloads"]})
BIG = 2**31 + 12345


def _sizes(reqs):
    return [(len(r.prompt), r.max_new_tokens) for r in reqs]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_trace(name):
    t = manifest.traffic(name)
    a = mix.plan(t, BIG, 49152)
    b = mix.plan(t, BIG, 49152)
    assert _sizes(a) == _sizes(b)
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert len(a) == t["requests"]


@pytest.mark.parametrize("name", MIXES)
def test_seeds_draw_their_own_sizes(name):
    """Two seeds hold different work, not the same sizes reordered."""
    t = manifest.traffic(name)
    a, b = mix.plan(t, 5, 49152), mix.plan(t, 6, 49152)
    assert sorted(len(r.prompt) for r in a) != \
        sorted(len(r.prompt) for r in b)
    assert sorted(r.max_new_tokens for r in a) != \
        sorted(r.max_new_tokens for r in b)


@pytest.mark.parametrize("name", MIXES)
def test_lengths_follow_their_distributions(name):
    t = manifest.traffic(name)
    reqs = mix.plan(t, 9, 49152)
    p = np.array([len(r.prompt) for r in reqs])
    o = np.array([r.max_new_tokens for r in reqs[t["clients"]:]])
    for x, d in ((p, t["prompt"]), (o, t["output"])):
        assert d["lo"] <= x.min() and x.max() <= d["hi"]
        # uniform: the mean within four standard errors
        sd = (d["hi"] - d["lo"] + 1) / 12 ** 0.5
        assert abs(x.mean() - (d["lo"] + d["hi"]) / 2) < 4 * sd / len(x) ** .5
    # drawn independently, prompt lengths recur
    assert len(set(p.tolist())) < len(p)
    assert all(1 <= r.max_new_tokens <= t["output"]["hi"] for r in reqs)


def test_residual_lengths_are_the_stationary_residual():
    """Uniform lifetimes 64..192: the residual's mean is E[L^2] / (2 E[L])
    (plus a half for counting from 1), about 70."""
    d = {"dist": "uniform", "lo": 64, "hi": 192}
    p = mix.residual_probabilities(d)
    r = np.arange(1, len(p) + 1)
    L = np.arange(64, 193)
    assert p.sum() == pytest.approx(1.0)
    assert (p * r).sum() == pytest.approx(
        (L ** 2).mean() / (2 * L.mean()) + 0.5, rel=1e-9)


def test_first_requests_take_residual_lengths():
    t = dict(manifest.traffic(MIXES[0]), clients=2000, requests=2000)
    outs = np.array([r.max_new_tokens for r in mix.plan(t, 3, 49152)])
    p = mix.residual_probabilities(t["output"])
    want = (p * np.arange(1, len(p) + 1)).sum()
    assert outs.min() >= 1 and outs.mean() == pytest.approx(want, rel=0.05)


def test_unknown_distribution_is_refused():
    with pytest.raises(ValueError):
        mix.support({"dist": "zipf", "lo": 1, "hi": 9})
