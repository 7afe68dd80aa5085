"""The paged decode step reading the LMB tier's onboard pool in place.

A round whose page union fits the onboard tier in one wave hands the
step the tier's own pool (``DecodeView.direct``): no page is copied
before or after the step, and the staged step captures its graphs
against that pool.  A round that spills gathers its pages into the
staged step's pool buffer, which is made only then.  Reduced f32
qwen2-1.5b and dbrx-132b serve short requests (every union fits 12
onboard pages), then long ones (the unions spill), on the eager and the
staged engine: the same streams and logits, the buffer made only at the
first spill, and on the card graphs on both pools.  No JAX here, so the
``cuda`` test runs on the card (the twins against the reference are in
``tests/test_torch_staged.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import system_for
from repro_torch.core.metrics import GLOBAL_METRICS
from repro_torch.kernels import cuda_build
from repro_torch.models import build_model
from repro_torch.models.flags import Flags
from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec

ARCHS = ("qwen2-1.5b", "dbrx-132b")
ECFG = dict(decode_slots=4, max_seq_len=64, page_tokens=8,
            onboard_pages=12, round_time_s=1e-3)
#: short requests whose unions fit 12 onboard pages (at most 4 x 2), then
#: long ones whose unions spill past them (4 x 5-7)
SHORT = ((5, 7), (9, 5), (3, 6), (11, 4), (7, 6), (6, 5))
LONG = ((40, 6), (45, 5), (50, 4), (38, 6))


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    GLOBAL_METRICS.reset()
    yield


def _engine(arch, device, staged):
    model = build_model(get_config(arch).reduced(),
                        Flags(remat=False, use_kernels=True), device=device)
    params = model.init(torch.Generator(device).manual_seed(0))
    return ServeEngine(model, params,
                       system_for("dev0", host_id="h0", pool_gib=1,
                                  page_bytes=4096),
                       EngineConfig(**ECFG), device_id="dev0",
                       device=device, staged=staged)


def _two_phases(arch, device, staged):
    """Serve ``SHORT``, then ``LONG``; returns the engine, its streams, each
    paged step's logits (copies: a graph's output is static) and, after
    each phase, the store's and the staged step's stats and the staged
    step's graph keys."""
    eng = _engine(arch, device, staged)
    step, logits = eng._paged_fn, []

    def logged(*args):
        out = step(*args)
        logits.append(out[0].clone())
        return out

    eng._paged_fn = logged
    rng = np.random.default_rng(11)
    phases = []
    for load in (SHORT, LONG):
        rids = [eng.submit(SubmitSpec(
            prompt=rng.integers(1, 100, n).astype(np.int32),
            max_new_tokens=new)) for n, new in load]
        eng.run(400)
        assert all(eng.requests[r].state == "done" for r in rids)
        phases.append((eng.kv.stats(),
                       eng.staged.stats() if staged else None,
                       set(eng.staged.graphs) if staged else None))
    streams = [r.out_tokens for r in eng.requests.values()]
    return eng, streams, logits, phases


def _check_phases(eng, phases):
    """The short phase reads in place and makes no pool buffer; the long
    one spills and makes it."""
    (kv1, st1, _), (kv2, st2, _) = phases
    assert kv1["gathered_rounds"] == 0 and kv1["direct_rounds"] > 0
    assert st1["pool_pages"] == 0 and st1["regrowths"] == 0
    assert kv2["gathered_rounds"] > 0
    assert kv2["direct_rounds"] + kv2["gathered_rounds"] == eng.paged_rounds
    assert st2["pool_pages"] >= ECFG["onboard_pages"]
    assert st2["regrowths"] >= 1


@pytest.mark.parametrize("arch", ARCHS)
def test_the_pool_buffer_is_made_at_the_first_spill(arch):
    """On the CPU (no graph): the staged engine serves the eager one's
    streams and logits over both phases, reads the onboard pool in place
    while every union fits, and makes its pool buffer at the first round
    that spills."""
    eager_eng, eager, eager_logits, _ = _two_phases(arch, "cpu", False)
    eng, streams, logits, phases = _two_phases(arch, "cpu", True)
    assert streams == eager
    assert len(logits) == len(eager_logits) == eng.paged_rounds
    for got, want in zip(logits, eager_logits):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert eager_eng.kv.stats()["direct_rounds"] == \
        phases[1][0]["direct_rounds"]
    _check_phases(eng, phases)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_graphs_read_the_onboard_pool_on_the_card(arch):
    """On the card: graphs captured against the onboard tier's own pool
    replay with the eager step's logits, and the paged kernel launches
    layers x rounds through replays.  While every union fits, the staged
    step makes no pool buffer; the first round that spills makes it and
    captures a graph of its own against it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs and the CUDA "
                    "kernels have no CPU mode)")
    runs = []
    for staged in (False, True):
        cuda_build.reset_launch_counts()
        runs.append((*_two_phases(arch, "cuda", staged),
                     cuda_build.launch_counts()))
    (_, eager, eager_logits, _, eager_launch), \
        (eng, streams, logits, phases, launch) = runs
    assert streams == eager
    assert len(logits) == len(eager_logits) == eng.paged_rounds
    for got, want in zip(logits, eager_logits):
        torch.testing.assert_close(got, want)
    assert launch == eager_launch
    assert launch["paged_attention"] == eng.paged_rounds * eng.cfg.num_layers
    _check_phases(eng, phases)
    (_, st1, graphs1), (_, st2, graphs2) = phases
    onboard = eng.kv.buf._onboard_pool.data_ptr()
    buffer = eng.staged.pool.data_ptr()
    assert st1["replays"] > 0 and graphs1
    assert {ptr for ptr, _, _ in graphs1} == {onboard}
    assert {ptr for ptr, _, _ in graphs2} <= {onboard, buffer}
    assert any(ptr == buffer for ptr, _, _ in graphs2)
    assert st2["captures"] > st1["captures"]
