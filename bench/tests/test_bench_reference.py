"""The plain reference against the program at ``.reduced()`` size on the
CPU: the same weights (drawn by ``bench.weights``) give the same logits,
and a served run reads a widest gap of rounding only."""

import numpy as np
import pytest
import torch

from bench import check, deploy, manifest, weights
from bench.reference.model import Reference
from bench.tests import small

#: the benchmark's configuration, and one more of the program's models
#: (GQA with qk-norm and SwiGLU) in its place, so the reference's other
#: paths are held to the program too
PORTS = ["granite-34b", "chameleon-34b"]


@pytest.mark.parametrize("port", PORTS)
def test_reference_equals_the_programs_prefill(port):
    from repro_torch.models import build_model
    from repro_torch.models.flags import Flags
    cfg = small.config("granite-34b", port=port)
    model = build_model(deploy.arch_config(cfg), Flags(remat=False),
                        device="cpu")
    params = weights.make(model.abstract_params(), 11, "cpu", 0.02)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg["model"]["vocab_size"], 37), dtype=torch.int64)
    cache = model.init_cache(1, 64)
    want, _ = model.prefill(params, {"tokens": toks[None].to(torch.int32)},
                            cache)
    got = Reference(cfg["model"], params).logits([toks], [[36]])[0]
    assert torch.allclose(got[0], want[0], atol=2e-5, rtol=1e-4)
    # every position, against the program's prefill of each prefix
    ref = Reference(cfg["model"], params).logits([toks], [range(37)])[0]
    for S in (1, 8, 20):
        w, _ = model.prefill(params, {"tokens": toks[None, :S].to(
            torch.int32)}, model.init_cache(1, 64))
        assert torch.allclose(ref[S - 1], w[0], atol=2e-5, rtol=1e-4)


def test_weights_are_drawn_again_the_same():
    from repro_torch.models import build_model
    cfg = small.config("granite-34b")
    model = build_model(deploy.arch_config(cfg), device="cpu")
    a = weights.make(model.abstract_params(), 2**40 + 3, "cpu", 0.02)
    b = weights.make(model.abstract_params(), 2**40 + 3, "cpu", 0.02)
    c = weights.make(model.abstract_params(), 5, "cpu", 0.02)
    pa, pb, pc = (dict(weights.leaves(t)) for t in (a, b, c))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not torch.equal(pa[("embed", "table")], pc[("embed", "table")])
    assert torch.equal(pa[("final_norm", "scale")],
                       torch.ones_like(pa[("final_norm", "scale")]))


def test_served_tokens_agree_and_the_control_does_not():
    """The program's served tokens are the reference's own best (f32 on
    both sides); the float8 control's, put in the program's place and
    judged by the same verdict and limits, come out not correct."""
    res = small.run("granite-34b.completion", seed=4, control=True)
    assert res["correct"], res["check"]
    assert res["check"]["widest_gap"]["value"] < 1e-4
    assert res["check"]["served_tokens"]["value"] >= 20
    assert not res["control_correct"], res["control"]
    assert res["control"]["mean_gap"]["value"] > \
        res["check"]["mean_gap"]["value"]


def test_the_verdict_fails_the_control_at_the_cells_limits():
    """At the cell's own limits the verdict passes readings like the
    program's and fails readings like the float8 control's (PERF.md)."""
    cfg = manifest.config(manifest.load(), "granite-34b")
    lim = cfg["check"]
    n = lim["served_tokens_at_least"]
    sound = {"tokens": n, "widest_gap": 0.0, "mean_gap": 0.0}
    assert check.verdict(sound, lim)[0]
    for name, limit in lim["at_most"].items():
        assert not check.verdict(dict(sound, **{name: 2 * limit}), lim)[0]
    assert not check.verdict(dict(sound, tokens=n - 1), lim)[0]
    assert not check.verdict(dict(sound, mean_gap=float("nan")), lim)[0]


def test_sample_holds_the_longest_and_is_drawn_from_the_seed():
    fin = [(i, np.zeros(10 + i % 7), [1] * (3 + i % 5)) for i in range(20)]
    a = check.draw_sample(fin, 20, 1)
    assert a == check.draw_sample(fin, 20, 1)
    longest = max(fin, key=lambda f: len(f[1]) + len(f[2]))
    assert a[0][0] == longest[0]
    served = sum(len(s[2]) for s in a)
    # just enough requests to reach the served tokens asked for
    assert 20 <= served < 20 + 7
    assert [s[0] for s in check.draw_sample(fin, 20, 2)] != \
        [s[0] for s in a]
    assert len(check.draw_sample(fin, 10**6, 1)) == len(fin)
