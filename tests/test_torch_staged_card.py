"""The staged engine's CUDA graphs on the card (``serve/staged.py``),
against the eager engine on the same card.  No JAX here, so the machine
with the card runs this file (``PYTHONPATH=src python3 -m pytest -q
--noconftest -m cuda tests/test_torch_staged_card.py``); the staged
engine's CPU twins against the reference are in
``tests/test_torch_staged.py``, ``test_torch_staged_prefill.py`` and
``test_torch_staged_slots.py``, whose loads and engine settings these
tests serve, on weights drawn from a seeded ``torch.Generator``.

For each staged function (the paged step, the prefill, the dense slot
step) the staged engine must give the eager engine's streams, link
bytes, onboard hits and misses, dispatcher calls and kernel launches
(counted through replays), and for prefill its logits; its calls must
follow the capture rule (``tests/staged_rule.py``): each key's first
call eager, the first key met twice captured at its second call, the
rest as ``CaptureRule`` says.  A host sync inside a staged function
must make the engine raise at its first capture rather than run
eagerly.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import system_for
from repro_torch.core.metrics import GLOBAL_METRICS
from repro_torch.kernels import cuda_build, ops
from repro_torch.models import build_model
from repro_torch.models.flags import Flags
from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec

import staged_rule

#: the paged step: decode slots 4, pages of 8 tokens, 5 onboard (the
#: working set spills); requests finish at different rounds, so the
#: decode batch takes several sizes
STEP = dict(archs=("qwen2-1.5b", "dbrx-132b"),
            ecfg=dict(decode_slots=4, max_seq_len=64, page_tokens=8,
                      onboard_pages=5, round_time_s=1e-3),
            load=((5, 7), (13, 3), (20, 9), (9, 5), (17, 4), (11, 6)),
            seed=7)
#: prefill, paged and dense slot configs: prompt 13 four times, 20 three
#: times, 7 twice; shorter lengths follow longer ones
PREFILL = dict(archs=("qwen2-1.5b", "dbrx-132b", "rwkv6-7b", "hymba-1.5b",
                      "h2o-danube-3-4b"),
               ecfg=dict(decode_slots=3, max_seq_len=64, page_tokens=8,
                         onboard_pages=5, round_time_s=1e-3),
               load=((13, 4), (20, 5), (13, 3), (7, 4), (20, 3), (13, 5),
                     (7, 2), (20, 4), (13, 3)),
               seed=5)
#: the dense slot step: 3 decode slots for 6 requests (slots reused)
SLOTS = dict(archs=("rwkv6-7b", "hymba-1.5b", "h2o-danube-3-4b",
                    "mixtral-8x22b"),
             ecfg=PREFILL["ecfg"], load=STEP["load"], seed=7)


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    GLOBAL_METRICS.reset()
    yield


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs and the CUDA "
                    "kernels have no CPU mode)")
    return torch.device("cuda")


def _engine(arch, ecfg, device, **kw):
    model = build_model(get_config(arch).reduced(),
                        Flags(remat=False, use_kernels=True), device=device)
    params = model.init(torch.Generator(device).manual_seed(0))
    # RWKV6 serves with kv_prefetch off, as its CPU twins do
    ecfg = dict(ecfg, **({"kv_prefetch": False} if arch == "rwkv6-7b"
                         else {}))
    return ServeEngine(model, params,
                       system_for("dev0", host_id="h0", pool_gib=1,
                                  page_bytes=4096),
                       EngineConfig(**ecfg), device_id="dev0",
                       device=device, **kw)


def _serve(eng, plan):
    """Serve ``plan``'s load; returns ((streams, link bytes, (hits,
    misses), dispatcher calls made), each prefill's logits)."""
    logits, prefill = [], eng._prefill_fn

    def recorded(*args):
        out = prefill(*args)
        logits.append(out[0].float().cpu().numpy())
        return out

    eng._prefill_fn = recorded
    rng = np.random.default_rng(plan["seed"])
    before = ops.dispatch_counts()
    tier = eng.kv.buf.metrics.tier(eng.kv.buf.name, "onboard")
    seen = (tier.hits, tier.misses)       # the registry is process-wide
    rids = [eng.submit(SubmitSpec(
        prompt=rng.integers(1, 100, n).astype(np.int32),
        max_new_tokens=new)) for n, new in plan["load"]]
    eng.run(400)
    assert all(eng.requests[r].state == "done" for r in rids)
    used = {k: n - before[k] for k, n in ops.dispatch_counts().items()}
    return ([eng.requests[r].out_tokens for r in rids],
            eng.kv.buf.host.fm.op_bytes(),
            (tier.hits - seen[0], tier.misses - seen[1]), used), logits


def _eager_and_staged(arch, plan, device, staged_fn):
    """``plan`` served by an eager and a staged engine on ``device``:
    (eager, staged), each (observed, prefill logits, launches), the
    staged engine, and the (key, mode) calls of its staged function
    ``staged_fn`` (an engine attribute)."""
    runs = []
    for staged in (False, True):
        eng = _engine(arch, plan["ecfg"], device, staged=staged)
        calls = (staged_rule.recording(getattr(eng, staged_fn)) if staged
                 else None)
        cuda_build.reset_launch_counts()
        observed, logits = _serve(eng, plan)
        runs.append((observed, logits, cuda_build.launch_counts()))
    return runs[0], runs[1], eng, calls


@pytest.mark.cuda
@pytest.mark.parametrize("arch", STEP["archs"])
def test_captured_graphs_match_eager_on_the_card(cuda_device, arch):
    """Staged against eager on the card: the same streams, link bytes,
    hits and misses, and the paged kernel launched layers x rounds in
    both, counted through replays; each B's first round eager, the first
    B met twice captured at its second round, every other B captured as
    the rule says (a pool-buffer regrowth drops the graphs)."""
    eager, staged, eng, calls = _eager_and_staged(arch, STEP, cuda_device,
                                                  "staged")
    assert staged[0] == eager[0]
    assert staged[2] == eager[2]
    assert staged[2]["paged_attention"] == \
        eng.paged_rounds * eng.cfg.num_layers
    st = eng.staged.stats()
    staged_rule.check_rule(calls, st, graphs_dropped=True)
    assert st["eager_calls"] == len(st["calls"]) + st["eager_repeats"]
    assert len(st["calls"]) > 1 and st["captures"] > 0
    assert st["replays"] == eng.paged_rounds - st["eager_calls"] > 0


@pytest.mark.cuda
def test_a_host_sync_in_the_step_raises(cuda_device):
    """Capture refuses a host sync inside the step: the first round at
    B = 1 runs eagerly, the second is the function's first capture, and
    the engine raises there and does not carry on eagerly."""
    eng = _engine("qwen2-1.5b", STEP["ecfg"], cuda_device)
    step = eng.staged.step

    def syncing(params, pool, page_table, lengths, token):
        int(lengths.max())                  # a host sync
        return step(params, pool, page_table, lengths, token)

    eng.staged.step = syncing
    eng.submit(SubmitSpec(prompt=np.arange(1, 9, dtype=np.int32),
                          max_new_tokens=4))
    with pytest.raises(RuntimeError):
        eng.run(10)
    assert eng.staged.captures == 0
    assert eng.paged_rounds == eng.staged.eager_calls == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", PREFILL["archs"])
def test_captured_prefill_graphs_match_eager_on_the_card(cuda_device, arch):
    """Staged against eager on the card: the same streams, link bytes,
    hits and misses, prefill logits and launch counts; each length's
    first prefill eager, the first length met twice (13) captured at its
    second prefill and replayed after, every other length captured as
    the rule says."""
    eager, staged, eng, calls = _eager_and_staged(arch, PREFILL,
                                                  cuda_device,
                                                  "staged_prefill")
    assert staged[0] == eager[0]
    assert staged[2] == eager[2]
    assert len(staged[1]) == len(PREFILL["load"])
    for got, want in zip(staged[1], eager[1]):
        np.testing.assert_array_equal(got, want)
    st = eng.staged_prefill.stats()
    staged_rule.check_rule(calls, st)
    assert calls[2] == (13, "capture")
    assert st["eager_calls"] == len(st["calls"]) + st["eager_repeats"]
    assert st["replays"] == len(PREFILL["load"]) - st["eager_calls"] > 0


@pytest.mark.cuda
def test_a_host_sync_in_prefill_raises(cuda_device):
    """Capture refuses a host sync inside prefill: a length's first
    prefill runs eagerly, its second is the function's first capture, and
    the engine raises there and does not carry on eagerly."""
    eng = _engine("qwen2-1.5b", PREFILL["ecfg"], cuda_device)
    prefill = eng.staged_prefill.step

    def syncing(params, batch, cache):
        int(batch["tokens"].sum())          # a host sync
        return prefill(params, batch, cache)

    eng.staged_prefill.step = syncing
    for _ in range(2):
        eng.submit(SubmitSpec(prompt=np.arange(1, 9, dtype=np.int32),
                              max_new_tokens=4))
    with pytest.raises(RuntimeError):
        eng.run(10)
    assert eng.staged_prefill.captures == 0
    assert eng.staged_prefill.eager_calls == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", SLOTS["archs"])
def test_captured_slot_graphs_match_eager_on_the_card(cuda_device, arch):
    """Staged against eager on the card: the same streams, link bytes,
    hits and misses and launch counts; each slot's first step eager, the
    first slot stepped twice captured at its second step, every other
    slot captured as the rule says, and a captured slot replayed
    after."""
    eager, staged, eng, calls = _eager_and_staged(arch, SLOTS, cuda_device,
                                                  "staged")
    assert staged[0] == eager[0]
    assert staged[2] == eager[2]
    st = eng.staged.stats()
    staged_rule.check_rule(calls, st)
    steps = st["calls"].values()
    assert len(steps) == st["slots"] == SLOTS["ecfg"]["decode_slots"]
    assert st["eager_calls"] == len(steps) + st["eager_repeats"]
    assert st["captures"] > 0
    assert st["replays"] == sum(steps) - st["eager_calls"] > 0


@pytest.mark.cuda
def test_a_host_sync_in_the_slot_step_raises(cuda_device):
    """Capture refuses a host sync inside the step: the slot's first step
    runs eagerly, the second is the function's first capture, and the
    engine raises there and does not carry on eagerly."""
    eng = _engine("h2o-danube-3-4b", SLOTS["ecfg"], cuda_device)
    step = eng.staged.step

    def syncing(params, cache, token):
        int(cache["step"])                  # a host sync
        return step(params, cache, token)

    eng.staged.step = syncing
    eng.submit(SubmitSpec(prompt=np.arange(1, 9, dtype=np.int32),
                          max_new_tokens=4))
    with pytest.raises(RuntimeError):
        eng.run(10)
    assert eng.staged.captures == 0
    assert eng.staged.eager_calls == 1
