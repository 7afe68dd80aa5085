"""The port's LinkedBuffer in lockstep with the JAX reference's.

One seeded mix of operations drives a ``repro.core.buffer.LinkedBuffer``
and a ``repro_torch.core.buffer.LinkedBuffer`` side by side: scalar and
batched reads and writes, zero-copy sharing and release, pins (one that
overflows the onboard tier), scheduled prefetch under an overlap window,
hot-page migration between two expanders, and an expander failure with
reads and writes in degraded mode until it is readmitted.  After every
operation both sides must hold the same data in every page, the same
tiers, refcounts, hit and miss counters, link bytes, modelled link wait,
page heat, prefetch statistics and LMB placement, and both must pass
``check_invariants``; an operation that raises must raise the same
exception type on both.  Parametrised over the eviction policy, int8
compression of cold pages and the number of expanders.

A write to a shared page is where the two differ by design: the
reference's copy-on-write leaks the old physical page and drops the
refcount, and the port writes through instead (its module docstring).
The lockstep mix therefore writes only to pages held once, and
:func:`test_write_to_a_shared_page_leaks_in_the_reference_not_the_port`
shows both behaviours.

Modelling mode, as in ``test_torch_serve.py``: the reference's
``backend_memory_kinds`` is patched to ``("device",)`` (this JAX refuses
its ``pinned_host`` gathers) and the port's executor is
``TierExecutor("cpu")``.  Data is float32 and moves between tiers
unchanged, so the comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.offload
from repro.core import system_for as jsystem_for
from repro.core.metrics import Metrics as JMetrics
from repro.core.overlap import OverlapScheduler as JOverlapScheduler
from repro.core.tiers import TierKind as JTierKind
from repro.core.tiers import tpu_tiers as jtpu_tiers
from repro_torch.core import TierExecutor, system_for
from repro_torch.core.metrics import Metrics
from repro_torch.core.overlap import OverlapScheduler
from repro_torch.core.tiers import TierKind, tpu_tiers

PAGE = (2, 4)
N_PAGES = 16
ONBOARD = 4
CHUNK = 4
N_OPS = 140
#: the operation at which an expander fails, and the one that readmits it
FAIL_AT, REPAIR_AT = 70, 105


@pytest.fixture
def modelling_reference(monkeypatch):
    monkeypatch.setattr(repro.core.offload, "backend_memory_kinds",
                        lambda: ("device",))


def _side(pkg, policy, compress, n_expanders):
    """One package's system and buffer, built through its client API."""
    if pkg == "jax":
        make_system, metrics = jsystem_for, JMetrics()
        overlap = JOverlapScheduler(jtpu_tiers()[JTierKind.HOST_DRAM],
                                    compute_window_s=1e-6)
        extra = {"dtype": jnp.float32}
    else:
        make_system, metrics = system_for, Metrics()
        overlap = OverlapScheduler(tpu_tiers()[TierKind.HOST_DRAM],
                                   compute_window_s=1e-6)
        extra = {"dtype": torch.float32, "executor": TierExecutor("cpu")}
    system = make_system("d0", host_id="h0", n_expanders=n_expanders,
                         pool_gib=1, page_bytes=1 << 16, metrics=metrics)
    buf = system.buffer(name="twin", device_id="d0", page_shape=PAGE,
                        onboard_pages=ONBOARD, lmb_chunk_pages=CHUNK,
                        policy=policy, prefetch_depth=4,
                        prefetch_min_burst=1, overlap=overlap,
                        compress_lmb=compress, metrics=metrics, **extra)
    return system, buf


def _peek(buf):
    """Every page's logical contents, read from the pools without
    touching the buffer's state (no fault, no meter, no heat)."""
    out = np.zeros((buf.num_pages, *PAGE), np.float32)
    for p, e in enumerate(buf._pages):
        if e.tier == "onboard":
            row = np.asarray(buf._onboard_pool[e.slot])
        elif e.tier == "lmb":
            chunk, off = divmod(e.slot, CHUNK)
            row = np.asarray(buf._lmb_pools[chunk][off], np.float32)
            if buf.compress_lmb:
                row = row * np.float32(buf._lmb_scales.get(e.slot, 0.0))
        else:
            continue
        out[p] = row
    return out


def _state(buf):
    c = buf.metrics.tier(buf.name, "onboard")
    return {
        "tiers": [buf.tier_of(p) for p in range(buf.num_pages)],
        "refcounts": [e.refcount for e in buf._pages],
        "hits_misses": (c.hits, c.misses),
        "op_bytes": buf.host.fm.op_bytes(),
        "link_wait_s": buf.link_wait_s,
        "prefetch": buf.prefetch_stats(),
        "placement": buf.lmb_placement(),
        "degraded": buf.degraded,
        "heat": [buf.page_heat(p) for p in range(buf.num_pages)],
    }


def _assert_same(jbuf, tbuf, what):
    np.testing.assert_array_equal(_peek(tbuf), _peek(jbuf), err_msg=what)
    js, ts = _state(jbuf), _state(tbuf)
    for key in js:
        assert ts[key] == js[key], f"{what}: {key} {ts[key]} != {js[key]}"
    jbuf.check_invariants()
    tbuf.check_invariants()


def _run(fn_j, fn_t, raised=None):
    """Apply one operation to both sides; both succeed with the same
    result, or both raise the same exception type (added to ``raised``)."""
    out = []
    for fn in (fn_j, fn_t):
        try:
            out.append(("ok", fn()))
        except Exception as exc:       # compared below: same type on both
            out.append(("raised", type(exc).__name__))
    assert out[0][0] == out[1][0], out
    if out[0][0] == "raised":
        assert out[0][1] == out[1][1], out
        if raised is not None:
            raised.add(out[0][1])
    return out


def _ops(rng, n_expanders):
    """The seeded operation list: (kind, args)."""
    ops = []
    for i in range(N_OPS):
        if i == FAIL_AT:
            ops.append(("fail", ()))
            continue
        if i == REPAIR_AT:
            ops.append(("repair", ()))
            continue
        kinds = ["read", "write", "read_many", "write_many", "share",
                 "release", "pin", "pin_many", "prefetch"]
        if n_expanders == 2:
            kinds.append("migrate")
        kind = kinds[int(rng.integers(len(kinds)))]
        pages = [int(p) for p in rng.integers(0, N_PAGES,
                                              int(rng.integers(2, 7)))]
        data = rng.standard_normal((len(pages), *PAGE)).astype(np.float32)
        ops.append((kind, (pages, data, float(rng.choice([1e-7, 1e-5,
                                                         1e-3])))))
    return ops


@pytest.mark.parametrize("n_expanders", [1, 2])
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("policy", ["lru", "clock", "cost"])
def test_buffer_twin_in_lockstep(modelling_reference, policy, compress,
                                 n_expanders):
    rng = np.random.default_rng(
        100 + 10 * ["lru", "clock", "cost"].index(policy) + 2 * compress
        + n_expanders)
    jsys, jbuf = _side("jax", policy, compress, n_expanders)
    tsys, tbuf = _side("torch", policy, compress, n_expanders)
    seen, raised, migrated = set(), set(), 0

    def run(fn_j, fn_t):
        return _run(fn_j, fn_t, raised)

    jbuf.append_pages(N_PAGES)
    tbuf.append_pages(N_PAGES)
    # every page written once: the working set spills past the onboard
    # tier into the LMB chunks
    first = rng.standard_normal((N_PAGES, *PAGE)).astype(np.float32)
    for p in range(N_PAGES):
        run(lambda: jbuf.write(p, jnp.asarray(first[p])),
             lambda: tbuf.write(p, torch.from_numpy(first[p])))
    _assert_same(jbuf, tbuf, "after the first writes")
    shared, pinned, failed = [], [], None
    for i, (kind, args) in enumerate(_ops(rng, n_expanders)):
        what = f"op {i} {kind}"
        seen.add(kind)
        if kind == "fail":
            # kill the expander homing the most LMB pages
            placement = jbuf.lmb_placement()
            failed = max(placement, key=placement.get) if placement else \
                jsys.fm.expander_ids[0]
            jsys.inject_failure(failed)
            tsys.inject_failure(failed)
            assert tbuf.degraded == jbuf.degraded == (n_expanders == 1)
        elif kind == "repair":
            jsys.readmit_expander(failed)
            tsys.readmit_expander(failed)
            assert not tbuf.degraded
        else:
            pages, data, window = args
            if kind in ("write", "write_many"):
                # only pages held once: see the module docstring
                keep = [i for i, q in enumerate(pages)
                        if jbuf._pages[q].refcount <= 1]
                pages, data = [pages[i] for i in keep], data[keep]
                if not pages:
                    _assert_same(jbuf, tbuf, what)
                    continue
            p = pages[0]
            if kind == "read":
                got = run(lambda: jbuf.read(p), lambda: tbuf.read(p))
                if got[0][0] == "ok":
                    np.testing.assert_array_equal(got[1][1].numpy(),
                                                  np.asarray(got[0][1]))
            elif kind == "write":
                run(lambda: jbuf.write(p, jnp.asarray(data[0])),
                     lambda: tbuf.write(p, torch.from_numpy(data[0])))
            elif kind == "read_many":
                got = run(lambda: jbuf.read_many(pages),
                           lambda: tbuf.read_many(pages))
                if got[0][0] == "ok":
                    np.testing.assert_array_equal(got[1][1].numpy(),
                                                  np.asarray(got[0][1]))
            elif kind == "write_many":
                run(lambda: jbuf.write_many(pages, jnp.asarray(data)),
                     lambda: tbuf.write_many(pages,
                                             torch.from_numpy(data)))
            elif kind == "share":
                if len(pages) > 3:
                    run(lambda: jbuf.share_many(pages[:2]),
                         lambda: tbuf.share_many(pages[:2]))
                    shared += pages[:2]
                else:
                    run(lambda: jbuf.share(p), lambda: tbuf.share(p))
                    shared.append(p)
            elif kind == "release":
                q = shared.pop() if shared else p
                run(lambda: jbuf.release(q), lambda: tbuf.release(q))
            elif kind == "pin":
                if pinned:
                    q = pinned.pop()
                    run(lambda: jbuf.unpin(q), lambda: tbuf.unpin(q))
                else:
                    run(lambda: jbuf.pin(p), lambda: tbuf.pin(p))
                    pinned.append(p)
            elif kind == "pin_many":
                # more distinct pages than the onboard tier holds must
                # raise; a batch that fits is pinned, then unpinned
                many = list(dict.fromkeys(pages + list(range(N_PAGES))))
                want = many[:ONBOARD + 1] if len(pages) > 4 else \
                    many[:2]
                got = run(lambda: jbuf.pin_many(want),
                           lambda: tbuf.pin_many(want))
                if len(want) > ONBOARD:
                    assert got[0] == ("raised", "OutOfMemory"), got
                    seen.add("pin overflow")
                elif got[0][0] == "ok":
                    _assert_same(jbuf, tbuf, what + " (pinned)")
                    run(lambda: jbuf.unpin_many(want),
                         lambda: tbuf.unpin_many(want))
            elif kind == "prefetch":
                # prefetch never evicts: free onboard slots first by
                # releasing the batch's onboard pages held once, then
                # schedule LMB-resident pages under a pinned window
                for q in dict.fromkeys(pages):
                    if (jbuf.tier_of(q) == "onboard" and q not in pinned
                            and jbuf._pages[q].refcount == 1):
                        run(lambda: jbuf.release(q),
                             lambda: tbuf.release(q))
                pages = [q for q in range(N_PAGES)
                         if jbuf.tier_of(q) == "lmb"][:len(pages)]
                run(lambda: jbuf.note_compute_window(window,
                                                      observed=False),
                     lambda: tbuf.note_compute_window(window,
                                                      observed=False))
                run(lambda: jbuf.schedule_prefetch(pages),
                     lambda: tbuf.schedule_prefetch(pages))
            elif kind == "migrate":
                movers = [q for q in range(N_PAGES)
                          if jbuf.page_expander(q) is not None][:3]
                if movers:
                    dst = 1 - jbuf.page_expander(movers[0])
                    got = run(lambda: jbuf.migrate_pages(movers, dst),
                               lambda: tbuf.migrate_pages(movers, dst))
                    assert got[0] == got[1]
                    if got[0][0] == "ok":
                        migrated += got[0][1]
        _assert_same(jbuf, tbuf, what)
    # every page read back through the buffer: the same data on both
    np.testing.assert_array_equal(
        tbuf.read_many(range(N_PAGES)).numpy(),
        np.asarray(jbuf.read_many(list(range(N_PAGES)))))
    _assert_same(jbuf, tbuf, "final read")
    # the mix reached every path it names, the link carried pages, and
    # prefetch issued bursts
    assert seen >= {"read", "write", "read_many", "write_many", "share",
                    "release", "pin", "pin_many", "prefetch", "fail",
                    "repair"} | ({"migrate"} if n_expanders == 2 else set())
    assert "pin overflow" in seen
    assert tbuf.host.fm.op_bytes().get("demand", 0) > 0
    assert tbuf.prefetch_stats()["bursts"] > 0
    if n_expanders == 2:
        assert migrated > 0
    assert "OutOfMemory" in raised


@pytest.mark.parametrize("spilled", [False, True])
def test_write_to_a_shared_page_leaks_in_the_reference_not_the_port(
        modelling_reference, spilled):
    """A reference fault the port routes around.  ``share`` returns the
    same logical index, so the reference's copy-on-write puts the copy
    under that index: the old physical page (onboard, or in the LMB tier
    when ``spilled``) is left to no one and its slot leaks, and the
    refcount drops to 1, so the first holder's release frees the page
    under the second.  The port writes through in place: the buffer stays
    whole, the written data is what every holder reads in both, and the
    page lives until its last holder releases it."""
    new = np.full((1, *PAGE), 9.0, np.float32)
    for pkg in ("jax", "torch"):
        _, buf = _side(pkg, "lru", False, 1)
        wrap = jnp.asarray if pkg == "jax" else torch.from_numpy
        buf.append_pages(8)
        for q in range(8):
            buf.write(q, wrap(np.full(PAGE, q + 1.0, np.float32)))
        p = 0 if spilled else 7
        assert buf.tier_of(p) == ("lmb" if spilled else "onboard")
        assert buf.share(p) == p
        buf.write_many([p], wrap(new))
        np.testing.assert_array_equal(np.asarray(buf.read(p)), new[0])
        if pkg == "jax":
            with pytest.raises(AssertionError, match="slot leak"):
                buf.check_invariants()
            buf.release(p)                       # the first holder
            assert buf.tier_of(p) is None        # freed under the second
            assert float(np.asarray(buf.read(p)).max()) == 0.0
        else:
            buf.check_invariants()
            assert buf._pages[p].refcount == 2
            buf.release(p)                       # the first holder
            np.testing.assert_array_equal(buf.read(p).numpy(), new[0])
            buf.release(p)                       # the last holder
            assert buf.tier_of(p) is None
            buf.check_invariants()


def test_pages_past_a_64th_of_a_block_spill_in_the_port_not_the_reference(
        modelling_reference):
    """A reference fault the port routes around.  The LMB tier grows in
    chunks of ``lmb_chunk_pages`` (64) pages, one capability allocation
    each, which must lie in one 256 MiB pool block; a page of more than
    4 MiB, such as chameleon-34b's KV page of 6,291,456 B (48 layers x 2
    x 32 tokens x 8 KV heads x 128, bf16), makes the first spill raise
    ``OutOfMemory`` in the reference.  The port takes as many pages a
    chunk as a block holds (42 here) and spills."""
    from repro.core.pool import BLOCK_BYTES as JBLOCK_BYTES
    from repro.core.pool import OutOfMemory as JOutOfMemory
    from repro_torch.core.pool import BLOCK_BYTES
    page = (48, 2, 32, 8, 128)
    page_bytes = int(np.prod(page)) * 2
    assert page_bytes == 6_291_456 and BLOCK_BYTES == JBLOCK_BYTES
    for pkg in ("jax", "torch"):
        make_system = jsystem_for if pkg == "jax" else system_for
        system = make_system("d0", host_id="h0", pool_gib=1)
        extra = {"dtype": jnp.bfloat16} if pkg == "jax" else {
            "dtype": torch.bfloat16, "executor": TierExecutor("cpu")}
        buf = system.buffer(name="kv", device_id="d0", page_shape=page,
                            onboard_pages=1, **extra)
        buf.append_pages(2)
        if pkg == "jax":
            buf.write(0, jnp.full(page, 2.0, jnp.bfloat16))
            with pytest.raises(JOutOfMemory, match="exceeds one"):
                buf.write(1, jnp.ones(page, jnp.bfloat16))   # page 0 spills
            continue
        assert buf._lmb_chunk_pages == BLOCK_BYTES // page_bytes == 42
        buf.write(0, torch.full(page, 2.0, dtype=torch.bfloat16))
        buf.write(1, torch.ones(page, dtype=torch.bfloat16))  # page 0 spills
        assert (buf.tier_of(0), buf.tier_of(1)) == ("lmb", "onboard")
        assert float(buf.read(0).float().mean()) == 2.0
        assert float(buf.read(1).float().mean()) == 1.0
        buf.check_invariants()
