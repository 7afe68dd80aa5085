"""The LMB tier's page moves on a card's copy streams
(``core/offload.TierExecutor``): a burst against a pinned pool is one
asynchronous copy per run of consecutive slots, reads on the H2D stream
and writes on the D2H stream, ordered by events.

On the CPU the executor's streams are a recording stand-in (``Recorder``
in ``tests/stream_recorder.py``, vector clocks per stream) whose
``moves`` names the buffer's LMB pools, which forces the pinned-pool
branch on CPU tensors; every copy runs at once, so the values are real.
The schedule tests read each happens-before edge the executor promises
off one recorded run, and show that dropping any one wait breaks its
edge:
  (a) an H2D into a tensor waits for the compute stream's last use of it;
  (b) the compute stream's use of a read waits for its H2D;
  (c) a D2H waits for the compute stream that produced its source;
  (d) an H2D from an LMB slot waits for every earlier D2H into it;
  (e) a D2H into an LMB slot waits for every earlier H2D from it (by way
      of (b) and (c));
  (f) a pool is dropped only after its copies have landed;
  (g) the host reads a pool's bytes only after its D2Hs have landed.
Values are compared exactly (copies move bytes); the engine against the
reference and against its own modelling mode: identical token streams,
link bytes per class, onboard hits and misses and buffer statistics.
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
from repro_torch.core import TierExecutor, offload, system_for
from repro_torch.core.buffer import LinkedBuffer
from repro_torch.core.metrics import GLOBAL_METRICS
from repro_torch.interop import params_from_numpy
from repro_torch.models import build_model
from repro_torch.models.flags import Flags
from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec
from repro_torch.serve.kv_cache import PagedKVStore
from stream_recorder import Recorder, before

EDGES = ("a", "b", "c", "d", "e", "f", "g")


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    GLOBAL_METRICS.reset()
    yield


def _forced(monkeypatch):
    """A recorder every new executor takes as its copy streams; it pages
    nothing until ``rec.paged`` names the pools."""
    rec = Recorder(paged=lambda t: False)
    monkeypatch.setattr(offload, "copy_streams", lambda device: rec)
    return rec


def _lmb_pools_of(buf):
    return lambda t: any(t is p for p in buf._lmb_pools)


def _instrument(ex, rec):
    """Log the executor's onboard gathers and scatters as compute-stream
    operations (where the compute stream reads and writes pages)."""
    read, write = ex._read_pages, ex._write_pages

    def gather(pool, slots, out=None):
        if not rec.moves(pool):
            rec.op("gather")
        return read(pool, slots, out)

    def scatter(pool, slots, pages):
        if not rec.moves(pool):
            rec.op("scatter")
        return write(pool, slots, pages)
    ex._read_pages, ex._write_pages = gather, scatter


def _pool_side(o):
    """(pool storage, slots) the pool side of a copy touches."""
    v = o["src"] if o["stream"] == "h2d" else o["dst"]
    base = v.untyped_storage().data_ptr()
    first = (v.data_ptr() - base) // (v[0].numel() * v.element_size())
    return base, set(range(first, first + v.shape[0]))


def _edges(rec):
    """{edge: (instances, violations)} over the recorded schedule."""
    log = rec.log
    got = {e: [0, 0] for e in EDGES}

    def count(edge, a, b):
        got[edge][0] += 1
        got[edge][1] += not before(a, b)
    compute = [i for i, o in enumerate(log) if o["stream"] == "compute"]
    for i, o in enumerate(log):
        if o["kind"] != "copy":
            continue
        prev = [j for j in compute if j < i]
        if prev:
            count("a" if o["stream"] == "h2d" else "c", log[prev[-1]], o)
        if o["stream"] == "h2d":
            nxt = [j for j in compute if j > i]
            if nxt:
                count("b", o, log[nxt[0]])
        pool, slots = _pool_side(o)
        other = "d2h" if o["stream"] == "h2d" else "h2d"
        for w in log[:i]:
            if w["kind"] == "copy" and w["stream"] == other:
                wpool, wslots = _pool_side(w)
                if wpool == pool and wslots & slots:
                    count("d" if o["stream"] == "h2d" else "e", w, o)
    for h in log:
        if h["stream"] != "host":
            continue
        edge = "f" if h["kind"] == "drop" else "g"
        for c in log[:log.index(h)]:
            if c["kind"] == "copy" and _pool_side(c)[0] in h["pools"] and \
                    (edge == "f" or c["stream"] == "d2h"):
                count(edge, c, h)
    return {e: tuple(v) for e, v in got.items()}


def _kv_slab(rng, kv, T):
    L, _, _, KV, hd = kv.page_shape
    return torch.from_numpy(
        rng.standard_normal((L, 2, T, KV, hd)).astype(np.float32))


def _schedule(rec, kv):
    """Prefill three sequences past the onboard tier (evictions), decode
    rounds whose views wave (faults and evictions) and commits, a
    sequence freed and another's pages prefetched into the free slots, a
    direct read into a buffer last used by a "replay", the host reading
    the pools, then the buffer closed (every pool dropped)."""
    rng = np.random.default_rng(0)
    sids = [kv.new_seq() for _ in range(3)]
    for sid in sids:
        kv.append_tokens(sid, _kv_slab(rng, kv, 10))
    for _ in range(3):
        view = kv.decode_view(sids, max_pages=4)
        rec.op("step", t=view.pool)
        pool = view.pool.clone()
        pool[view.tail_index] += 1.0
        kv.commit_decode(view, pool)
    kv.free_seq(sids[0])
    kv.schedule_prefetch(kv.seq(sids[1]).pages)
    buf, ex = kv.buf, kv.buf.executor
    pools = [p for p in buf._lmb_pools if p is not None]
    rows = torch.empty((4, *kv.page_shape))
    rec.op("replay", t=rows)
    ex.read_pages(pools[0], [0, 1, 1, 3], out=rows)
    rec.op("step", t=rows)
    assert torch.equal(rows, pools[0][[0, 1, 1, 3]])
    ex.settle()
    rec.host_op("read", pools={p.untyped_storage().data_ptr()
                               for p in pools})
    buf.close()
    rec.host_op("drop", pools={p.untyped_storage().data_ptr()
                               for p in pools})
    return rows


def _recorded_store(monkeypatch):
    rec = _forced(monkeypatch)
    kv = PagedKVStore(cfg=get_config("qwen2-1.5b").reduced(),
                      system=system_for("dev0", pool_gib=1,
                                        page_bytes=4096),
                      device_id="dev0", page_tokens=4, onboard_pages=4,
                      prefetch_depth=2, device="cpu")
    rec.paged = _lmb_pools_of(kv.buf)
    _instrument(kv.buf.executor, rec)
    return rec, kv


def test_the_schedule_holds_every_edge(monkeypatch):
    """Every edge (a)-(g) has instances in the run, and none is broken;
    each burst is one copy per run of consecutive slots, and every D2H
    source is kept for the D2H stream."""
    rec, kv = _recorded_store(monkeypatch)
    rows = _schedule(rec, kv)
    edges = _edges(rec)
    for e, (n, bad) in edges.items():
        assert n > 0, f"edge ({e}) never arose"
        assert bad == 0, f"edge ({e}) broken {bad} of {n} times"
    copies = [o for o in rec.log if o["kind"] == "copy"]
    assert {o["stream"] for o in copies} == {"h2d", "d2h"}
    # the direct read of slots [0, 1, 1, 3]: runs [0, 1], [1], [3]
    direct = [o for o in copies if o["dst"].untyped_storage().data_ptr()
              == rows.untyped_storage().data_ptr()]
    assert [len(o["dst"]) for o in direct] == [2, 1, 1]
    d2h = [o for o in copies if o["stream"] == "d2h"]
    assert len(rec.kept) > 0 and all(s == "d2h" for _, s in rec.kept)
    kept = {t.untyped_storage().data_ptr() for t, _ in rec.kept}
    assert all(o["src"].untyped_storage().data_ptr() in kept for o in d2h)


def _drop(rec, ex, edge):
    """Remove the one wait that enforces ``edge``."""
    fork, wait = rec.fork, rec.wait
    if edge in ("a", "c"):
        stream = "h2d" if edge == "a" else "d2h"
        rec.fork = lambda s: None if s == stream else fork(s)
    elif edge == "b":
        rec.wait = lambda s, e: None if s == "compute" else wait(s, e)
    elif edge == "d":
        rec.wait = lambda s, e: None if s == "h2d" and \
            e is ex._write_done else wait(s, e)
    else:
        rec.synchronize = lambda e: None


@pytest.mark.parametrize("edge,broken", [
    ("a", "a"), ("b", "be"), ("c", "ce"), ("d", "d"), ("settle", "fg")])
def test_dropping_a_wait_breaks_its_edge(monkeypatch, edge, broken):
    """The edges are not vacuous: with the one wait that enforces an edge
    removed, the recorder finds it broken.  (e) has no wait of its own:
    it follows from (b) then (c), and falls with either; the host's wait
    (``settle``) holds (f) and (g)."""
    rec, kv = _recorded_store(monkeypatch)
    _drop(rec, kv.buf.executor, edge)
    _schedule(rec, kv)
    edges = _edges(rec)
    for e in broken:
        assert edges[e][1] > 0, f"edge ({e}) still holds"


def test_runs_split_at_gaps_and_repeats():
    assert offload._runs([4, 5, 6, 9, 9, 10, 2]) == [
        [0, 4, 3], [3, 9, 1], [4, 9, 2], [6, 2, 1]]
    assert offload._runs([]) == []


# ------------------------------------------------------------ values
def _buffer(page_shape=(2, 4), onboard=4):
    return LinkedBuffer(
        name="buf", device_id="dev0",
        host=system_for("dev0", pool_gib=1, page_bytes=4096).host(),
        executor=TierExecutor("cpu"), page_shape=page_shape,
        dtype=torch.float32, onboard_pages=onboard, policy="cost",
        prefetch_depth=2)


@pytest.mark.parametrize("seed", range(5))
def test_random_interleavings_equal_a_dict_of_pages(monkeypatch, seed):
    """Seeded random reads, writes, batched reads and writes (waves past
    the 4-page onboard tier) and the evictions they force, pages freed
    and held again, and prefetch bursts into the slots that frees,
    through the streamed path: every read, and at the end every
    LMB-resident page's bytes in its pool, equal a dict-of-pages model;
    the run's hits, misses, link bytes and residency equal the same
    sequence in modelling mode."""
    n, shape = 14, (2, 4)
    runs = []
    for forced in (True, False):
        rec = _forced(monkeypatch) if forced else None
        if not forced:
            monkeypatch.setattr(offload, "copy_streams",
                                lambda device: offload.HostStreams(device))
        GLOBAL_METRICS.reset()
        buf = _buffer()
        if forced:
            rec.paged = _lmb_pools_of(buf)
        buf.append_pages(n)
        model = {p: torch.zeros(shape) for p in range(n)}
        rng = np.random.default_rng(seed)
        for _ in range(200):
            kind = rng.integers(0, 6)
            if kind == 5:
                # freed and held again: zeros, and an onboard slot free
                # for a prefetch burst
                p = int(rng.integers(0, n))
                buf.release(p)
                buf.share(p)
                model[p] = torch.zeros(shape)
            elif kind == 0:
                p = int(rng.integers(0, n))
                model[p] = torch.from_numpy(
                    rng.standard_normal(shape).astype(np.float32))
                buf.write(p, model[p])
            elif kind == 1:
                p = int(rng.integers(0, n))
                assert torch.equal(buf.read(p), model[p])
            elif kind == 2:
                pages = [int(x) for x in rng.integers(0, n, 6)]
                data = torch.from_numpy(rng.standard_normal(
                    (6, *shape)).astype(np.float32))
                buf.write_many(pages, data)
                for i, p in enumerate(pages):
                    model[p] = data[i].clone()
            elif kind == 3:
                pages = [int(x) for x in rng.integers(0, n, 7)]
                got = buf.read_many(pages)
                assert torch.equal(got, torch.stack([model[p]
                                                     for p in pages]))
            else:
                buf.schedule_prefetch(
                    [int(x) for x in rng.integers(0, n, 3)])
        buf.executor.settle()
        for p, e in enumerate(buf._pages):
            if e.tier == "lmb":
                chunk, off = divmod(e.slot, buf._lmb_chunk_pages)
                assert torch.equal(buf._lmb_pools[chunk][off], model[p])
        assert torch.equal(buf.read_many(list(range(n))),
                           torch.stack([model[p] for p in range(n)]))
        buf.check_invariants()
        c = buf.metrics.tier("buf", "onboard")
        runs.append((c.hits, c.misses, buf.host.fm.op_bytes(),
                     [buf.tier_of(p) for p in range(n)],
                     buf.prefetch_stats(), buf.link_wait_s))
        if forced:
            kinds = {o["stream"] for o in rec.log if o["kind"] == "copy"}
            assert kinds == {"h2d", "d2h"}
    assert runs[0] == runs[1]
    assert runs[0][1] > 0 and runs[0][4]["bursts"] > 0


# ------------------------------------------------------------ engine
@pytest.fixture
def modelling_reference(monkeypatch):
    monkeypatch.setattr(repro.core.offload, "backend_memory_kinds",
                        lambda: ("device",))


def _engine(params, prompts, **cfg_kw):
    eng = ServeEngine(
        build_model(get_config("qwen2-1.5b").reduced(), Flags(remat=False),
                    device="cpu"),
        params, system_for("dev0", host_id="h0", pool_gib=1,
                           page_bytes=4096),
        EngineConfig(**cfg_kw), device_id="dev0", device="cpu")
    rids = [eng.submit(SubmitSpec(prompt=p, max_new_tokens=6))
            for p in prompts]
    return eng, rids


def test_engine_streamed_equals_reference_and_modelling_mode(
        modelling_reference, monkeypatch):
    """A reduced qwen2-1.5b engine whose KV waves through 4 onboard
    pages, with the streamed path forced: the reference's token streams,
    link bytes per class, hits and misses; its own modelling mode's
    buffer statistics (waits, prefetch, residency) and meter calls."""
    cfg_kw = dict(decode_slots=4, max_seq_len=64, page_tokens=8,
                  onboard_pages=4, trace=True, round_time_s=1e-3)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 100, 20).astype(np.int32) for _ in range(6)]
    jparams = jbuild_model(jget_config("qwen2-1.5b").reduced(),
                           JFlags(remat=False)).init(jax.random.key(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    jeng = JServeEngine(
        jbuild_model(jget_config("qwen2-1.5b").reduced(),
                     JFlags(remat=False)),
        jparams, jsystem_for("dev0", host_id="h0", pool_gib=1,
                             page_bytes=4096),
        JEngineConfig(**cfg_kw), device_id="dev0")
    jrids = [jeng.submit(JSubmitSpec(prompt=p, max_new_tokens=6))
             for p in prompts]
    jeng.run(400)
    jc = jeng.kv.buf.metrics.tier(jeng.kv.buf.name, "onboard")
    want = ([jeng.requests[r].out_tokens for r in jrids],
            jeng.kv.buf.host.fm.op_bytes(), (jc.hits, jc.misses))
    got = []
    for forced in (True, False):
        GLOBAL_METRICS.reset()
        rec = _forced(monkeypatch)
        eng, rids = _engine(params, prompts, **cfg_kw)
        if forced:
            rec.paged = _lmb_pools_of(eng.kv.buf)
        eng.run(400)
        assert all(eng.requests[r].state == "done" for r in rids)
        c = eng.kv.buf.metrics.tier(eng.kv.buf.name, "onboard")
        assert ([eng.requests[r].out_tokens for r in rids],
                eng.kv.buf.host.fm.op_bytes(), (c.hits, c.misses)) == want
        copies = [o["stream"] for o in rec.log if o["kind"] == "copy"]
        assert ("h2d" in copies and "d2h" in copies) == forced
        got.append((eng.kv.stats(), eng.paged_rounds,
                     eng.kv.buf.host.fm.meter_calls()))
    assert got[0] == got[1]
    assert want[2][1] > 0 and want[1].get("demand", 0) > 0
