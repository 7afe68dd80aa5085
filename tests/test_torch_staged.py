"""The staged paged decode step (``serve/staged.py``) against the eager
port engine and the JAX reference's ``ServeEngine``.

On the CPU the engine's static-buffer path runs with the step called
directly (no CUDA graph exists there): each round's pages are gathered
into the pool buffer, its other inputs copied into the fixed buffers, and
the step reads only those.  Reduced f32
qwen2-1.5b and dbrx-132b, served by the reference (its paged step under
``jax.jit``), the eager port engine (``staged=False``) and the staged
one, must give the same greedy streams, link bytes, onboard hits and
misses, and the same dispatcher calls.  Batch sizes vary from round to
round (requests of different lengths finish at different rounds), so the
step runs at several B.  Modelling mode, as in ``test_torch_serve.py``.

The captured graphs' card tests, which need no JAX, are in
``tests/test_torch_staged_card.py``.
"""

import jax
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
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.flags import Flags
from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec
from repro_torch.serve.staged import StagedStep

ARCHS = ("qwen2-1.5b", "dbrx-132b")
#: decode slots 4, pages of 8 tokens, 5 onboard: the working set spills
ECFG = dict(decode_slots=4, max_seq_len=64, page_tokens=8, onboard_pages=5,
            round_time_s=1e-3)
#: prompt lengths and new tokens: requests finish at different rounds, so
#: the decode batch takes several sizes
LOAD = ((5, 7), (13, 3), (20, 9), (9, 5), (17, 4), (11, 6))


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


def _port_engine(arch, jax_params, device="cpu", ecfg=ECFG, **kw):
    model = build_model(get_config(arch).reduced(),
                        Flags(remat=False, use_kernels=True), device=device)
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jax_params[arch]), device=device)
    return ServeEngine(model, params,
                       system_for("dev0", host_id="h0", pool_gib=1,
                                  page_bytes=4096),
                       EngineConfig(**ecfg), device_id="dev0",
                       device=device, **kw)


def _reference_engine(arch, jax_params, ecfg=ECFG):
    return JServeEngine(
        jbuild_model(jget_config(arch).reduced(),
                     JFlags(remat=False, use_kernels=True)),
        jax_params[arch], jsystem_for("dev0", host_id="h0", pool_gib=1,
                                      page_bytes=4096),
        JEngineConfig(**ecfg), device_id="dev0")


def _serve(eng, spec):
    """Serve ``LOAD``; returns (streams, link bytes, (hits, misses),
    dispatcher calls made)."""
    rng = np.random.default_rng(7)
    before = ops.dispatch_counts()
    tier = eng.kv.buf.metrics.tier(eng.kv.buf.name, "onboard")
    seen = (tier.hits, tier.misses)       # the registry is process-wide
    rids = [eng.submit(spec(prompt=rng.integers(1, 100, n).astype(np.int32),
                            max_new_tokens=new)) for n, new in LOAD]
    eng.run(400)
    assert all(eng.requests[r].state == "done" for r in rids)
    used = {k: n - before[k] for k, n in ops.dispatch_counts().items()}
    return ([eng.requests[r].out_tokens for r in rids],
            eng.kv.buf.host.fm.op_bytes(),
            (tier.hits - seen[0], tier.misses - seen[1]), used)


@pytest.mark.parametrize("arch", ARCHS)
def test_staged_engine_matches_eager_and_reference(modelling_reference,
                                                   jax_params, arch):
    ref = _serve(_reference_engine(arch, jax_params), JSubmitSpec)[:3]
    eager_eng = _port_engine(arch, jax_params, staged=False)
    staged_eng = _port_engine(arch, jax_params)
    assert eager_eng.staged is None
    assert isinstance(staged_eng.staged, StagedStep)
    eager, staged = (_serve(e, SubmitSpec) for e in (eager_eng, staged_eng))
    assert staged[:3] == eager[:3] == ref
    assert staged[3] == eager[3]
    assert staged[2][1] > 0 and staged[1].get("demand", 0) > 0   # spills
    layers = staged_eng.cfg.num_layers
    assert staged[3]["paged_attention_decode"] == \
        staged_eng.paged_rounds * layers
    st = staged_eng.staged.stats()
    assert sum(st["calls"].values()) == staged_eng.paged_rounds
    assert len(st["calls"]) > 1                     # several batch sizes
    assert st["captures"] == st["replays"] == 0      # no graph on the CPU
    assert st["eager_calls"] == staged_eng.paged_rounds
    assert st["pool_pages"] >= ECFG["onboard_pages"]


def test_pages_are_gathered_into_the_pool_buffer(jax_params):
    """A round whose union fits the onboard tier in one wave reads the
    tier's own pool in place; one that spills gathers its pages straight
    into the pool buffer's rows (no second copy).  The buffer is made at
    the first spilling round, from the onboard tier's page count, and
    doubles only as far as the largest spilled union needs."""
    eng = _port_engine("qwen2-1.5b", jax_params)
    view_fn, seen, direct = eng.kv.decode_view, [], []

    def view(*args, **kw):
        v = view_fn(*args, **kw)
        if v.direct:
            assert v.pool.data_ptr() == eng.kv.buf._onboard_pool.data_ptr()
            assert len(v.pool) == ECFG["onboard_pages"]
            direct.append(len(v.pages))
        else:
            assert v.pool.data_ptr() == eng.staged.pool.data_ptr()
            seen.append(len(v.pool))
        return v

    eng.kv.decode_view = view
    _serve(eng, SubmitSpec)
    assert len(seen) + len(direct) == eng.paged_rounds
    kv = eng.kv.stats()
    assert (kv["direct_rounds"], kv["gathered_rounds"]) == (len(direct),
                                                            len(seen))
    assert direct and max(direct) <= ECFG["onboard_pages"]
    size, doublings = ECFG["onboard_pages"], 0
    while size < max(seen):
        size, doublings = 2 * size, doublings + 1
    st = eng.staged.stats()
    assert min(seen) > ECFG["onboard_pages"]      # only spilling rounds
    assert st["pool_pages"] == size
    assert 1 <= st["regrowths"] <= doublings      # made, then grown


#: two mixes of ``LOAD``: every round's union fits the onboard tier in one
#: wave (4 slots of at most 8 pages, 32 onboard), or the working set
#: spills past 5 onboard pages (rounds that fit read in place, the rest
#: gather in waves)
MIXES = {"fits": dict(ECFG, onboard_pages=32), "spills": ECFG}


def _lockstep(eng, spec):
    """Serve ``LOAD`` a step at a time; returns the streams and, after
    every step, every page's tier, the onboard (hits, misses) and the
    link bytes."""
    rng = np.random.default_rng(7)
    buf = eng.kv.buf
    tier = buf.metrics.tier(buf.name, "onboard")
    seen = (tier.hits, tier.misses)       # the registry is process-wide
    rids = [eng.submit(spec(prompt=rng.integers(1, 100, n).astype(np.int32),
                            max_new_tokens=new)) for n, new in LOAD]
    steps = []
    while eng.waiting or eng.active:
        assert len(steps) < 400
        eng.step()
        steps.append(([buf.tier_of(p) for p in range(buf.num_pages)],
                      (tier.hits - seen[0], tier.misses - seen[1]),
                      dict(buf.host.fm.op_bytes())))
    return [eng.requests[r].out_tokens for r in rids], steps


def _paths(eng):
    """Record each view's path: (direct, union pages, waves it took)."""
    view_fn, paths = eng.kv.decode_view, []

    def view(*args, **kw):
        waves = eng.kv.buf.waves
        v = view_fn(*args, **kw)
        paths.append((v.direct, len(v.pages), eng.kv.buf.waves - waves))
        return v

    eng.kv.decode_view = view
    return paths


@pytest.mark.parametrize("mix", list(MIXES))
@pytest.mark.parametrize("arch", ARCHS)
def test_direct_rounds_are_the_reference_step_by_step(modelling_reference,
                                                      jax_params, arch,
                                                      mix):
    """Reading the onboard pool in place changes no accounting: after
    every step the eager and the staged port engines hold every page in
    the reference's tier, with its hits, misses and link bytes, and serve
    its streams.  A round reads in place exactly when its union fits the
    onboard tier (one wave); the others gather in waves, and the store's
    counters count each path."""
    ecfg = MIXES[mix]
    ref = _lockstep(_reference_engine(arch, jax_params, ecfg), JSubmitSpec)
    for staged in (False, True):
        eng = _port_engine(arch, jax_params, ecfg=ecfg, staged=staged)
        paths = _paths(eng)
        assert _lockstep(eng, SubmitSpec) == ref
        assert len(paths) == eng.paged_rounds > 0
        for direct, pages, waves in paths:
            assert direct == (pages <= ecfg["onboard_pages"])
            assert (waves == 1) if direct else (waves > 1)
        kv = eng.kv.stats()
        assert kv["direct_rounds"] == sum(d for d, _, _ in paths) > 0
        assert kv["gathered_rounds"] == sum(not d for d, _, _ in paths)
        if mix == "fits":
            assert kv["gathered_rounds"] == 0
            assert eng.staged is None or eng.staged.pool is None
        else:
            assert kv["gathered_rounds"] > 0
    if mix == "fits":
        assert all(t != "lmb" for tiers, _, _ in ref[1] for t in tiers)
    else:
        assert any(t == "lmb" for tiers, _, _ in ref[1] for t in tiers)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_page_written_in_place_is_evicted_with_its_token(jax_params,
                                                          arch):
    """The K/V a direct round's step writes into the onboard pool in place
    reaches the LMB tier: the commit marks the tail page dirty (a fresh
    page, clean until then), an eviction later demotes it, and it reads
    back holding the decoded token's K/V."""
    eng = _port_engine(arch, jax_params)
    model, params, kv = eng.model, eng.params, eng.kv
    L, _, T, KV, hd = kv.page_shape
    gen = torch.Generator().manual_seed(1)
    a = kv.new_seq()
    kv.append_tokens(a, torch.randn((L, 2, T, KV, hd), generator=gen))
    view = kv.decode_view([a], max_pages=eng._max_pages)
    assert view.direct
    assert view.pool.data_ptr() == kv.buf._onboard_pool.data_ptr()
    tail = view.tail_pages[0]
    assert tail != kv.seq(a).pages[0] and not kv.buf._pages[tail].dirty
    _, pool = model.decode_step_paged(
        params, view.pool, torch.as_tensor(view.tables),
        torch.as_tensor(view.lengths), torch.tensor([[5]], dtype=torch.int32))
    assert pool is view.pool
    token = pool[view.tail_index[0], :, :, 0].clone()      # [L, 2, KV, hd]
    assert bool(token.abs().sum() > 0)
    kv.commit_decode(view, pool)
    assert kv.buf._pages[tail].dirty
    assert kv.seq(a).length == T + 1
    # another sequence fills the onboard tier: a's pages go to the LMB
    b = kv.new_seq()
    kv.append_tokens(b, torch.randn((L, 2, T * ECFG["onboard_pages"], KV,
                                     hd), generator=gen))
    assert kv.buf.tier_of(tail) == "lmb"
    back = kv.gather_seq(a)
    assert kv.buf.tier_of(tail) == "onboard"
    torch.testing.assert_close(back[:, :, T], token, rtol=0, atol=0)


@pytest.mark.parametrize("pages", [[3], [3, 3], [0, 1, 2], [2, 0, 2],
                                   [0, 5, 0, 7, 1, 6]])
def test_read_many_into_out_is_read_many(pages):
    """``LinkedBuffer.read_many(out=)`` gathers into ``out`` what it
    returns without, and ``read_in_place`` hands out the onboard slots
    that hold it: the same pages, link bytes, hits, misses and waves, on
    the one-page path and a single wave.  Past the onboard tier (3 pages)
    ``read_many`` waves, and ``read_in_place`` returns None, touching
    nothing."""
    from repro_torch.core.metrics import Metrics
    from repro_torch.core.offload import TierExecutor
    runs = []
    for mode in ("plain", "out", "in_place"):
        metrics = Metrics()
        system = system_for("d0", host_id="h0", pool_gib=1,
                            page_bytes=1 << 16, metrics=metrics)
        buf = system.buffer(name="kv", device_id="d0", page_shape=(4, 8),
                            onboard_pages=3, dtype=torch.float32,
                            executor=TierExecutor("cpu"), metrics=metrics)
        buf.append_pages(8)
        for p in range(8):
            buf.write(p, torch.full((4, 8), float(p)))
        tier = metrics.tier("kv", "onboard")
        if mode == "in_place":
            before = (buf.waves, tier.hits, tier.misses,
                      buf.host.fm.op_bytes())
            got = buf.read_in_place(pages)
            if got is None:
                assert len(set(pages)) > 3
                assert before == (buf.waves, tier.hits, tier.misses,
                                  buf.host.fm.op_bytes())
                got = buf.read_many(pages)
            else:
                slots, pool = got
                assert pool is buf._onboard_pool
                got = pool[slots]
                buf.wrote_in_place([])
        else:
            out = (torch.full((len(pages), 4, 8), float("nan"))
                   if mode == "out" else None)
            got = buf.read_many(pages, out=out)
            if out is not None:
                assert got.data_ptr() == out.data_ptr()
        runs.append((got.clone(), buf.host.fm.op_bytes(),
                     (tier.hits, tier.misses), buf.waves))
    (plain, *rest), *others = runs
    assert [float(r[0, 0]) for r in plain] == [float(p) for p in pages]
    for got, *got_rest in others:
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
        assert got_rest == rest


def test_pages_read_in_place_stay_until_written():
    """No eviction may take a page ``read_in_place`` handed out until
    ``wrote_in_place`` takes it back; ``wrote_in_place`` takes back only
    pages handed out."""
    from repro_torch.core.buffer import InPlaceEviction
    from repro_torch.core.offload import TierExecutor
    system = system_for("d0", host_id="h0", pool_gib=1, page_bytes=1 << 16)
    buf = system.buffer(name="kv", device_id="d0", page_shape=(4, 8),
                        onboard_pages=3, dtype=torch.float32,
                        executor=TierExecutor("cpu"))
    buf.append_pages(8)
    for p in range(8):
        buf.write(p, torch.full((4, 8), float(p)))
    slots, pool = buf.read_in_place([5, 6])
    with pytest.raises(ValueError, match="not handed out"):
        buf.wrote_in_place([7])
    with pytest.raises(InPlaceEviction):
        buf.read_many([0, 1])          # two evictions: one takes 5 or 6
    assert [float(pool[s][0, 0]) for s in slots] == [5.0, 6.0]
    buf.wrote_in_place([6])
    assert [float(r[0, 0]) for r in buf.read_many([0, 1])] == [0.0, 1.0]
    buf.check_invariants()


def test_params_swapped_for_other_tensors_raise(jax_params):
    """The graphs read params at the addresses they were captured with:
    params updated in place serve on, a leaf swapped for a new tensor
    raises."""
    eng = _port_engine("qwen2-1.5b", jax_params)
    rng = np.random.default_rng(3)
    eng.submit(SubmitSpec(prompt=rng.integers(1, 100, 9).astype(np.int32),
                          max_new_tokens=6))
    eng.run(3)
    assert eng.paged_rounds > 0
    norm = eng.params["final_norm"]
    with torch.no_grad():
        norm["scale"].mul_(1.0)
    eng.run(1)
    norm["scale"] = norm["scale"].clone()
    with pytest.raises(ValueError, match="in place"):
        eng.run(1)


def test_page_table_never_maps_a_pool_row_at_or_past_n(jax_params,
                                                        monkeypatch):
    """Each spilling round's page table maps only rows ``0..n-1`` of the
    pool buffer, and the rows past ``n`` are never read: they hold NaN
    here.  A direct round's table maps only onboard slots that hold a
    page, and the free slots, NaN here too, are never read.  The streams
    are the eager engine's."""
    stage = StagedStep._stage
    seen, free = [], []
    engines = []

    def poisoned(self, pool, page_table, lengths, token):
        B, read = stage(self, pool, page_table, lengths, token)
        table = self.page_table[:B]
        assert bool((table >= -1).all())
        if read is self.pool:
            n = pool.shape[0]
            assert int(table.max()) < n
            self.pool[n:] = float("nan")
            seen.append((B, n))
        else:
            buf = engines[0].kv.buf
            assert read.data_ptr() == buf._onboard_pool.data_ptr()
            mapped = set(table[table >= 0].tolist())
            assert mapped <= set(buf._onboard_owner)
            read[buf._onboard_free] = float("nan")
            free.append(len(buf._onboard_free))
        return B, read

    eager = _serve(_port_engine("qwen2-1.5b", jax_params, staged=False),
                   SubmitSpec)
    monkeypatch.setattr(StagedStep, "_stage", poisoned)
    engines.append(_port_engine("qwen2-1.5b", jax_params))
    eng = engines[0]
    staged = _serve(eng, SubmitSpec)
    assert staged == eager
    assert len(seen) + len(free) == eng.paged_rounds
    assert any(n < eng.staged.pool.shape[0] for _, n in seen)
    assert any(free)


def test_steps_run_at_the_exact_batch_size(modelling_reference, jax_params):
    """dbrx-132b's expert capacity follows the token count: the staged
    step runs every round at the live batch's own B (one graph each on
    the card), never padded, and its streams, and so its drops, are the
    reference's.  Padding a batch of 3 to 4 rows changes the real rows'
    logits: capacity ceil(K * B * 1.25 / E) grows from 2 to 3."""
    arch = "dbrx-132b"
    eng = _port_engine(arch, jax_params)
    rows, step = [], eng.staged.step

    def record(params, pool, page_table, lengths, token):
        rows.append((token.shape[0], len(eng.active)))
        return step(params, pool, page_table, lengths, token)

    eng.staged.step = record
    got = _serve(eng, SubmitSpec)
    assert got[:3] == _serve(_reference_engine(arch, jax_params),
                             JSubmitSpec)[:3]
    assert all(b == live for b, live in rows)
    assert sorted(eng.staged.calls) == sorted({b for b, _ in rows})

    cfg = eng.cfg
    model = eng.model
    gen = torch.Generator().manual_seed(0)
    T, MP, P = 8, 4, 12
    pool = torch.randn((P, cfg.num_layers, 2, T, cfg.num_kv_heads,
                        cfg.head_dim_), generator=gen)
    table = torch.arange(P, dtype=torch.int32).reshape(3, MP)
    lengths = torch.tensor([9, 20, 30], dtype=torch.int32)
    token = torch.tensor([[3], [5], [7]], dtype=torch.int32)
    exact, _ = model.decode_step_paged(eng.params, pool.clone(), table,
                                       lengths, token)
    padded, _ = model.decode_step_paged(
        eng.params, torch.cat([pool, pool[:1]]),
        torch.cat([table, torch.tensor([[P, -1, -1, -1]],
                                       dtype=torch.int32)]),
        torch.cat([lengths, torch.tensor([0], dtype=torch.int32)]),
        torch.cat([token, token[:1]]))
    assert not torch.allclose(exact, padded[:3])
