"""The staged dense-slot decode step (``serve/staged.py``,
:class:`StagedSlots`) against the eager port engine and the JAX
reference's ``ServeEngine``.

rwkv6-7b, hymba-1.5b, h2o-danube-3-4b and mixtral-8x22b decode on the
dense slot path: each request alone at B = 1 against its own cache, as
the reference's ``jax.jit(model.decode_step)`` does.  The staged engine
keeps one static cache per decode slot, copies a request's prefilled
cache into it when the request is seated, and steps it there; on the CPU
(no CUDA graph exists there) the step is called directly on those
buffers.  Reduced f32 configs, served by the reference, the eager port
engine (``staged=False``) and the staged one, must give the same greedy
streams, link bytes, onboard hits and misses, through ring wraps (prompts
past the reduced window of 16), slot reuse, and a preemption resumed in
another slot.  The cache's ``step`` is a 0-d int32 tensor, and the decode
step reads no tensor value on the host: it runs on ``meta`` tensors,
which hold none.  Modelling mode, as in ``test_torch_serve.py``.

The ``cuda`` tests run the captured slot graphs on the card: staged
against eager, and a host sync inside the step, which must make the
engine raise at the slot's second step rather than run eagerly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.offload
from repro.configs.base import get_config as jget_config
from repro.core import system_for as jsystem_for
from repro.models import build_model as jbuild_model
from repro.models.flags import Flags as JFlags
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SubmitSpec as JSubmitSpec
from repro_torch.configs.base import get_config
from repro_torch.core import system_for
from repro_torch.core.metrics import GLOBAL_METRICS
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import cuda_build, ops
from repro_torch.models import build_model
from repro_torch.models.flags import Flags
from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec
from repro_torch.serve.staged import StagedSlots

#: the decoder-only configs on the dense slot path, one per block type
#: (RWKV6, HYBRID, DENSE with a sliding window, MOE with one)
ARCHS = ("rwkv6-7b", "hymba-1.5b", "h2o-danube-3-4b", "mixtral-8x22b")
#: 3 decode slots for 6 requests: slots are reused; 5 onboard pages of 8
#: tokens: the KV spills past the onboard tier
ECFG = dict(decode_slots=3, max_seq_len=64, page_tokens=8, onboard_pages=5,
            round_time_s=1e-3)
#: prompt lengths and new tokens; 20 and 17 pass the reduced window of 16
LOAD = ((5, 7), (13, 3), (20, 9), (9, 5), (17, 4), (11, 6))
TOL = 1e-4


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    GLOBAL_METRICS.reset()
    yield


@pytest.fixture
def modelling_reference(monkeypatch):
    monkeypatch.setattr(repro.core.offload, "backend_memory_kinds",
                        lambda: ("device",))


@pytest.fixture(scope="module")
def jax_params():
    return {arch: jbuild_model(jget_config(arch).reduced(),
                               JFlags(remat=False)).init(jax.random.key(0))
            for arch in ARCHS}


def _ecfg(arch, **kw):
    # the reference serves RWKV6 with kv_prefetch off only: with it on it
    # asks for the tail page of a sequence that holds none
    return dict(ECFG, **({"kv_prefetch": False} if arch == "rwkv6-7b"
                         else {}), **kw)


def _port_engine(arch, jax_params, device="cpu", ecfg=None, **kw):
    model = build_model(get_config(arch).reduced(),
                        Flags(remat=False, use_kernels=True), device=device)
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jax_params[arch]), device=device)
    return ServeEngine(model, params,
                       system_for("dev0", host_id="h0", pool_gib=1,
                                  page_bytes=4096),
                       EngineConfig(**(ecfg or _ecfg(arch))),
                       device_id="dev0", device=device, **kw)


def _reference_engine(arch, jax_params, ecfg=None):
    return JServeEngine(
        jbuild_model(jget_config(arch).reduced(),
                     JFlags(remat=False, use_kernels=True)),
        jax_params[arch], jsystem_for("dev0", host_id="h0", pool_gib=1,
                                      page_bytes=4096),
        JEngineConfig(**(ecfg or _ecfg(arch))), device_id="dev0")


def _observed(eng, rids, seen):
    tier = eng.kv.buf.metrics.tier(eng.kv.buf.name, "onboard")
    return ([eng.requests[r].out_tokens for r in rids],
            eng.kv.buf.host.fm.op_bytes(),
            (tier.hits - seen[0], tier.misses - seen[1]))


def _hits(eng):
    tier = eng.kv.buf.metrics.tier(eng.kv.buf.name, "onboard")
    return tier.hits, tier.misses


def _serve(eng, spec, load=LOAD, seed=7):
    """Serve ``load``; returns (streams, link bytes, (hits, misses),
    dispatcher calls made)."""
    rng = np.random.default_rng(seed)
    before, seen = ops.dispatch_counts(), _hits(eng)
    rids = [eng.submit(spec(prompt=rng.integers(1, 100, n).astype(np.int32),
                            max_new_tokens=new)) for n, new in load]
    eng.run(400)
    assert all(eng.requests[r].state == "done" for r in rids)
    used = {k: n - before[k] for k, n in ops.dispatch_counts().items()}
    return (*_observed(eng, rids, seen), used)


@pytest.mark.parametrize("arch", ARCHS)
def test_staged_slots_match_eager_and_reference(modelling_reference,
                                                jax_params, arch):
    ref = _serve(_reference_engine(arch, jax_params), JSubmitSpec)[:3]
    eager_eng = _port_engine(arch, jax_params, staged=False)
    staged_eng = _port_engine(arch, jax_params)
    assert eager_eng.staged is None
    assert isinstance(staged_eng.staged, StagedSlots)
    eager, staged = (_serve(e, SubmitSpec) for e in (eager_eng, staged_eng))
    assert staged[:3] == eager[:3] == ref
    assert staged[3] == eager[3]
    assert staged_eng.stats()["decode_path"] == "dense"
    if arch != "rwkv6-7b":                  # the KV spills to LMB pages
        assert staged[2][1] > 0 and staged[1].get("demand", 0) > 0
    kernel = "rwkv6_scan" if arch == "rwkv6-7b" else "flash_attention"
    assert staged[3][kernel] == len(LOAD) * staged_eng.cfg.num_layers
    st = staged_eng.staged.stats()
    steps = sum(new - 1 for _, new in LOAD)   # the first token: prefill
    assert sum(st["steps"].values()) == st["eager_steps"] == steps
    assert st["captures"] == st["replays"] == 0      # no graph on the CPU
    assert st["slots"] == ECFG["decode_slots"]


def test_ring_wrap_decode_matches_reference(jax_params):
    """h2o-danube-3-4b with a prompt past its reduced window of 16: the
    prefill leaves the ring wrapped and each decode step writes slot
    ``step % 16``; logits within 1e-4 of the reference's at every step,
    with ``step`` a 0-d int32 tensor throughout."""
    arch, S, steps = "h2o-danube-3-4b", 23, 12
    jmodel = jbuild_model(jget_config(arch).reduced(), JFlags(remat=False))
    tmodel = build_model(get_config(arch).reduced(), Flags(remat=False),
                         device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jax_params[arch]), device="cpu")
    toks = np.random.default_rng(3).integers(1, 100, (1, S)).astype(np.int32)
    jl, jcache = jmodel.prefill(jax_params[arch],
                                {"tokens": jnp.asarray(toks)},
                                jmodel.init_cache(1, 64))
    tl, tcache = tmodel.prefill(params, {"tokens": torch.from_numpy(toks)},
                                tmodel.init_cache(1, 64))
    assert tcache["k"].shape[2] == 16 < S
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    nxt = int(np.argmax(np.asarray(jl)[0]))
    for i in range(steps):
        step = tcache["step"]
        assert step.dim() == 0 and step.dtype == torch.int32
        assert int(step) == int(jcache["step"]) == S + i
        jl, jcache = jmodel.decode_step(jax_params[arch], jcache,
                                        jnp.asarray([[nxt]], jnp.int32))
        tl, tcache = tmodel.decode_step(
            params, tcache, torch.tensor([[nxt]], dtype=torch.int32))
        assert tcache["step"] is step                 # advanced in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        nxt = int(np.argmax(np.asarray(jl)[0]))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_reads_no_value_on_the_host(arch):
    """``Model.decode_step`` on ``meta`` params, cache and token: a meta
    tensor has no values, so a read of one on the host (``int()``,
    ``.item()``, ``.tolist()``, a branch on a tensor) raises.  The step
    runs, gives logits of the right shape and leaves the cache's leaves
    where they were; reading the step itself would raise."""
    model = build_model(get_config(arch).reduced(), Flags(remat=False),
                        device="cpu")
    params = model.abstract_params()
    cache = model.init_cache(1, 64, device="meta")
    leaves = {k: v.data_ptr() for k, v in cache.items()}
    assert cache["step"].shape == () and cache["step"].dtype == torch.int32
    with pytest.raises(RuntimeError):
        int(cache["step"])
    logits, out = model.decode_step(
        params, cache, torch.empty((1, 1), dtype=torch.int32, device="meta"))
    assert logits.device.type == "meta"
    assert tuple(logits.shape) == (1, model.cfg.padded_vocab)
    assert out is cache and {k: v.data_ptr() for k, v in out.items()} == \
        leaves


def _preempting(eng, spec):
    """Two decode slots, three requests: after 3 steps request 0 is
    preempted and sent behind request 2, which takes its slot; request 0
    resumes in the slot request 1 leaves.  Returns (streams, link bytes,
    (hits, misses)) and the slots each request decoded in."""
    rng = np.random.default_rng(11)
    seen = _hits(eng)
    rids = [eng.submit(spec(prompt=rng.integers(1, 100, n).astype(np.int32),
                            max_new_tokens=new))
            for n, new in ((19, 12), (6, 5), (9, 8))]
    slots = {r: [] for r in rids}
    it = 0
    while (eng.waiting or eng.active) and it < 100:
        if it == 3:
            eng.preempt(next(s for s, r in eng.active.items()
                             if r.req_id == rids[0]))
            eng.waiting.append(eng.waiting.popleft())
        eng.step()
        for s, r in eng.active.items():
            if not slots[r.req_id] or slots[r.req_id][-1] != s:
                slots[r.req_id].append(s)
        it += 1
    assert all(eng.requests[r].state == "done" for r in rids)
    return _observed(eng, rids, seen), slots


def test_preempt_and_resume_in_another_slot(modelling_reference,
                                            jax_params):
    """h2o-danube-3-4b: request 0 is preempted after 3 steps; request 2
    takes its slot (and overwrites that slot's cache) before request 0
    resumes in another.  The streams, link bytes, hits and misses are the
    eager engine's and the reference's."""
    arch = "h2o-danube-3-4b"
    ecfg = _ecfg(arch, decode_slots=2)
    ref, _ = _preempting(_reference_engine(arch, jax_params, ecfg),
                         JSubmitSpec)
    eager, eager_slots = _preempting(
        _port_engine(arch, jax_params, ecfg=ecfg, staged=False), SubmitSpec)
    eng = _port_engine(arch, jax_params, ecfg=ecfg)
    staged, slots = _preempting(eng, SubmitSpec)
    assert staged == eager == ref
    assert slots == eager_slots == {0: [0, 1], 1: [1], 2: [0]}


def test_a_ninth_request_goes_through_a_used_slot(modelling_reference,
                                                  jax_params):
    """Eight slots, nine requests: the ninth waits for a slot, is seated in
    one another request decoded in, and its stream (and every other) is
    the eager engine's and the reference's."""
    arch = "h2o-danube-3-4b"
    ecfg = _ecfg(arch, decode_slots=8, onboard_pages=8)
    load = ((7, 4), (18, 6), (9, 3), (12, 5), (21, 4), (5, 6), (14, 3),
            (10, 5), (17, 6))
    ref = _serve(_reference_engine(arch, jax_params, ecfg), JSubmitSpec,
                 load)[:3]
    eager = _serve(_port_engine(arch, jax_params, ecfg=ecfg, staged=False),
                   SubmitSpec, load)[:3]
    eng = _port_engine(arch, jax_params, ecfg=ecfg)
    seat = eng.staged.seat
    seated = []
    eng.staged.seat = lambda slot, cache: (
        seated.append((slot, eng.staged.slots.get(slot) is not None)),
        seat(slot, cache))
    staged = _serve(eng, SubmitSpec, load)[:3]
    assert staged == eager == ref
    assert len(seated) == 9 and eng.staged.stats()["slots"] == 8
    assert [used for _, used in seated] == [False] * 8 + [True]
    assert eng.staged.slots[seated[8][0]].steps > load[8][1] - 1


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_captured_slot_graphs_match_eager_on_the_card(cuda_device,
                                                      jax_params, arch):
    """Staged against eager on the card: the same streams, link bytes,
    hits and misses and launch counts; each slot's first step eager, its
    second captured, the rest replayed."""
    runs = []
    for staged in (False, True):
        eng = _port_engine(arch, jax_params, device=cuda_device,
                           staged=staged)
        cuda_build.reset_launch_counts()
        runs.append((_serve(eng, SubmitSpec), cuda_build.launch_counts(),
                     eng))
    (eager, eager_launch, _), (staged, staged_launch, eng) = runs
    assert staged == eager
    assert staged_launch == eager_launch
    st = eng.staged.stats()
    steps = st["steps"].values()
    assert st["eager_steps"] == st["slots"] == ECFG["decode_slots"]
    assert st["captures"] == sum(n > 1 for n in steps) > 0
    assert st["replays"] == sum(steps) - st["eager_steps"] > 0


@pytest.mark.cuda
def test_a_host_sync_in_the_slot_step_raises(cuda_device, jax_params):
    """Capture refuses a host sync inside the step: the slot's first step
    runs eagerly, the second captures, and the engine raises there and
    does not carry on eagerly."""
    eng = _port_engine("h2o-danube-3-4b", jax_params, device=cuda_device)
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
    assert eng.staged.eager_steps == 1
