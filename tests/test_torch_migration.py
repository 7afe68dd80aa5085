"""Hot-page migration in the port against the JAX package.

``repro_torch.qos.migration`` is a verbatim copy of the reference's, and
its ``MigrationEngine`` drives whichever ``LinkedBuffer`` it is given, so
it is checked where it meets the port: twins of ``tests/test_migration.py``
run each of that file's buffer and engine cases on both packages'
buffers, keep the reference's assertions, and compare what each case
observed (page contents, placements, access-control entries, metered
bytes, journals, migration reports).  ``plan_rebalance`` is compared on
seeded demands.  Last, a two-expander serve sweep with a
``MigrationEngine`` run after every engine step goes in lockstep on both
packages: each round's ``MigrationReport``, the link bytes, the page
placements and the token streams must be equal.

Seven of the reference's own cases fail on this JAX (its ``pinned_host``
gathers); here the reference runs in modelling mode
(``backend_memory_kinds`` patched to ``("device",)``) and the port's
buffers hold CPU tensors (``TierExecutor("cpu")``), so data moves between
tiers unchanged and every comparison is exact.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.offload
import repro.qos as jqos
import repro.serve as jserve
import repro_torch.core as tcore
import repro_torch.qos as tqos
import repro_torch.serve as tserve
from repro.configs.base import get_config as jget_config
from repro.core.fabric import DeviceClass as JDeviceClass
from repro.core.fabric import DeviceInfo as JDeviceInfo
from repro.core.metrics import Metrics as JMetrics
from repro.core.pool import BLOCK_BYTES as JBLOCK_BYTES
from repro.core.pool import BLOCK_ID_STRIDE as JBLOCK_ID_STRIDE
from repro.models import build_model as jbuild_model
from repro.models.flags import Flags as JFlags
from repro_torch.configs.base import get_config
from repro_torch.core import TierExecutor
from repro_torch.core.fabric import DeviceClass, DeviceInfo
from repro_torch.core.metrics import GLOBAL_METRICS, Metrics
from repro_torch.core.pool import BLOCK_BYTES, BLOCK_ID_STRIDE
from repro_torch.interop import params_from_numpy
from repro_torch.models import build_model
from repro_torch.models.flags import Flags

PKGS = {
    "jax": types.SimpleNamespace(
        core=jcore, qos=jqos, serve=jserve, DeviceClass=JDeviceClass,
        DeviceInfo=JDeviceInfo, BLOCK_BYTES=JBLOCK_BYTES,
        BLOCK_ID_STRIDE=JBLOCK_ID_STRIDE, Metrics=JMetrics,
        full=lambda shape, v: jnp.full(shape, v),
        buf_kw=lambda: {"dtype": jnp.float32}),
    "torch": types.SimpleNamespace(
        core=tcore, qos=tqos, serve=tserve, DeviceClass=DeviceClass,
        DeviceInfo=DeviceInfo, BLOCK_BYTES=BLOCK_BYTES,
        BLOCK_ID_STRIDE=BLOCK_ID_STRIDE, Metrics=Metrics,
        full=lambda shape, v: torch.full(shape, float(v)),
        buf_kw=lambda: {"dtype": torch.float32,
                        "executor": TierExecutor("cpu")}),
}


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    """tests/conftest.py resets only the reference's GLOBAL_METRICS."""
    GLOBAL_METRICS.reset()
    yield


@pytest.fixture
def modelling_reference(monkeypatch):
    monkeypatch.setattr(repro.core.offload, "backend_memory_kinds",
                        lambda: ("device",))


# ---------------------------------------------- test_migration's helpers
def make_pooled(pk, n_expanders=2, pool_gib=1, page_bytes=1 << 16):
    system = pk.core.system_for("d0", host_id="h0", n_expanders=n_expanders,
                                pool_gib=pool_gib, page_bytes=page_bytes)
    return system.fm, system.host()


def make_buffer(pk, host, n_pages=12, onboard=2, chunk=4, **kw):
    buf = pk.core.LinkedBuffer(name="mig", device_id="d0", host=host,
                               page_shape=(8, 8), onboard_pages=onboard,
                               lmb_chunk_pages=chunk, **pk.buf_kw(), **kw)
    pages = buf.append_pages(n_pages)
    for i, p in enumerate(pages):
        buf.write(p, pk.full((8, 8), float(i + 1)))
    return buf, pages


def lmb_pages_of(buf, pages):
    return [p for p in pages if buf.page_expander(p) is not None]


def observed(fm, buf=None):
    """What a case leaves behind, for the cross-package comparison."""
    out = {"journal": [(j.op, j.detail) for j in fm.journal],
           "placement": fm.placement(), "op_bytes": fm.op_bytes(),
           "healthy": fm.healthy,
           "links": {eid: e["link"]["tenants"]
                     for eid, e in fm.snapshot()["expanders"].items()}}
    if buf is not None:
        out["pages"] = [np.asarray(buf.read(p)).tolist()
                        if buf.tier_of(p) is not None else None
                        for p in range(buf.num_pages)]
        out["page_expanders"] = [buf.page_expander(p)
                                 for p in range(buf.num_pages)]
        out["lmb_placement"] = buf.lmb_placement()
        out["heat"] = [buf.page_heat(p) for p in range(buf.num_pages)]
        out["degraded"] = buf.degraded
    return out


# ------------------------------------------- the cases, one per reference
def preserves_contents(pk):
    fm, host = make_pooled(pk)
    buf, pages = make_buffer(pk, host)
    lmb = lmb_pages_of(buf, pages)
    assert lmb, "working set never spilled"
    dst = 1 - buf.page_expander(lmb[0])
    assert buf.migrate_pages(lmb, dst) == len(lmb)
    buf.check_invariants()
    for p in lmb:
        assert buf.page_expander(p) == dst
        np.testing.assert_array_equal(np.asarray(buf.read(p)),
                                      np.full((8, 8), float(p + 1)))
    return observed(fm, buf)


def regrants_iommu_entries(pk):
    fm, host = make_pooled(pk)
    buf, pages = make_buffer(pk, host, n_pages=6, onboard=2, chunk=4)
    lmb = lmb_pages_of(buf, pages)
    src_blocks = [b for b in fm.snapshot()["held_blocks"]["h0"]
                  if fm.expander_of(b) == 0]
    assert src_blocks and all(fm.iommu.check("d0", b, 0)
                              for b in src_blocks)
    assert buf.migrate_pages(lmb, 1) == len(lmb)
    assert not any(fm.iommu.check("d0", b, 0) for b in src_blocks)
    dst_blocks = [b for b in fm.snapshot()["held_blocks"]["h0"]
                  if fm.expander_of(b) == 1]
    assert dst_blocks and all(fm.iommu.check("d0", b, 0)
                              for b in dst_blocks)
    assert fm.placement()[0] == 0 and fm.placement()[1] >= 1
    return {"src": src_blocks, "dst": dst_blocks, **observed(fm, buf)}


def conserves_metered_bytes(pk):
    fm, host = make_pooled(pk)
    buf, pages = make_buffer(pk, host)

    def metered(eid):
        return fm.snapshot()["expanders"][eid]["link"]["tenants"]["d0"][
            "bytes_total"]

    before = {eid: metered(eid) for eid in (0, 1)}
    moved = buf.migrate_pages(lmb_pages_of(buf, pages), 1)
    after = {eid: metered(eid) for eid in (0, 1)}
    page_b = buf.lmb_page_bytes
    assert after[0] - before[0] == moved * page_b
    assert after[1] - before[1] == moved * page_b
    return {"before": before, "after": after, **observed(fm, buf)}


def stops_cleanly_when_target_full(pk):
    fm, host = make_pooled(pk)
    buf, pages = make_buffer(pk, host, compress_lmb=True)
    fm.set_quota("h0", fm.held_bytes("h0"))
    assert fm.held_bytes("h0") < 2 * pk.BLOCK_BYTES
    assert buf.migrate_pages(lmb_pages_of(buf, pages), 1) == 0
    buf.check_invariants()
    for i, p in enumerate(pages):
        np.testing.assert_allclose(np.asarray(buf.read(p)),
                                   np.full((8, 8), float(i + 1)), rtol=2e-2)
    eng = pk.qos.MigrationEngine(fm)
    eng.register(buf)
    rep = eng.run_once()
    assert rep.pages_moved == 0
    return {"report": dataclasses.asdict(rep), **observed(fm, buf)}


def last_expander_failure_degrades(pk):
    fm, host = make_pooled(pk)
    buf, pages = make_buffer(pk, host)
    lmb = lmb_pages_of(buf, pages)
    buf.migrate_pages(lmb[:len(lmb) // 2], 1)
    fm.inject_failure(expander_id=0)
    assert fm.healthy and not buf.degraded
    fm.inject_failure(expander_id=1)
    assert not fm.healthy and buf.degraded
    assert all(buf.page_expander(p) is None for p in lmb)
    buf.check_invariants()
    with pytest.raises(Exception) as exc:
        host.alloc("d0", 4096)
    return {"refusal": type(exc.value).__name__, **observed(fm, buf)}


def failover_purges_stale_access_entries(pk):
    fm, host = make_pooled(pk)
    make_buffer(pk, host)
    dead = [b for b in fm.snapshot()["held_blocks"]["h0"]
            if fm.expander_of(b) == 0]
    assert dead and all(fm.iommu.check("d0", b, 0) for b in dead)
    fm.inject_failure(expander_id=0)
    assert not any(fm.iommu.check("d0", b, 0) for b in dead)
    return {"dead": dead, **observed(fm)}


def parameterless_failure_targets_a_healthy_expander(pk):
    fm, _ = make_pooled(pk)
    fm.inject_failure()
    assert fm.healthy
    fm.inject_failure()
    assert not fm.healthy
    assert [j.detail for j in fm.journal if j.op == "fail"] == \
        ["expander=0", "expander=1"]
    return observed(fm)


def engine_rejects_foreign_buffer(pk):
    fm_a, _ = make_pooled(pk)
    _, host_b = make_pooled(pk)
    buf_b, _ = make_buffer(pk, host_b)
    with pytest.raises(ValueError) as exc:
        pk.qos.MigrationEngine(fm_a).register(buf_b)
    return {"message": str(exc.value)}


def idempotent_toward_target(pk):
    fm, host = make_pooled(pk)
    buf, pages = make_buffer(pk, host)
    lmb = lmb_pages_of(buf, pages)
    assert buf.migrate_pages(lmb, 1) == len(lmb)
    assert buf.migrate_pages(lmb, 1) == 0
    buf.check_invariants()
    return observed(fm, buf)


def heat_ranks_hotter_pages_higher(pk):
    fm, host = make_pooled(pk)
    buf, pages = make_buffer(pk, host, n_pages=8, onboard=2)
    lmb = lmb_pages_of(buf, pages)
    hot, cold = lmb[0], lmb[-1]
    for _ in range(5):
        buf.read(hot)
    assert buf.page_heat(hot) > buf.page_heat(cold)
    ranked = buf.hottest_pages(4, expander_id=0)
    assert cold not in ranked[:1]
    return {"ranked": ranked, **observed(fm, buf)}


def engine_noop_below_threshold(pk):
    fm, host = make_pooled(pk)
    buf, _ = make_buffer(pk, host, n_pages=4, onboard=4)
    eng = pk.qos.MigrationEngine(fm)
    eng.register(buf)
    rep = eng.run_once()
    assert not rep.triggered and rep.pages_moved == 0
    assert "threshold" in rep.reason
    return {"report": dataclasses.asdict(rep), "stats": eng.stats()}


def engine_migrates_hot_pages_off_saturated_link(pk):
    fm, host = make_pooled(pk)
    buf, pages = make_buffer(pk, host)
    for _ in range(3):
        for p in pages:
            buf.read(p)
    assert fm.link_utilizations()[0] > 0.7
    eng = pk.qos.MigrationEngine(fm,
                                 pk.qos.MigrationPolicy(max_pages_per_round=4))
    eng.register(buf)
    rep = eng.run_once()
    assert rep.triggered and (rep.src_expander, rep.dst_expander) == (0, 1)
    assert rep.pages_moved == 4
    assert rep.bytes_moved == 4 * buf.lmb_page_bytes
    assert buf.lmb_placement().get(1, 0) == 4
    assert any(j.op == "migrate" for j in fm.journal)
    assert eng.stats()["pages_moved"] == 4
    buf.check_invariants()
    return {"report": dataclasses.asdict(rep), "stats": eng.stats(),
            **observed(fm, buf)}


def failover_replays_bw_shares_onto_standby(pk):
    fm, _ = pk.core.make_default_fabric(pool_gib=1, spare=True)
    fm.bind_host("h0")
    fm.register_device(pk.DeviceInfo("d0", pk.DeviceClass.PCIE))
    fm.register_device(pk.DeviceInfo("d1", pk.DeviceClass.PCIE))
    fm.set_bw_share("d0", 3.0, burst_bytes=1 << 20)
    host = pk.core.LMBHost(fm, "h0", page_bytes=4096)
    host.alloc("d0", 4096)
    fm.inject_failure()
    assert fm.healthy
    spare = fm.snapshot()["expanders"][1]["link"]["tenants"]
    assert spare["d0"]["weight"] == 3.0 and spare["d1"]["weight"] == 1.0
    assert len([j for j in fm.journal if j.op == "bw_share"
                and "replay" in j.detail]) == 2
    fm.meter_transfer("d0", 4096,
                      block_id=fm.snapshot()["held_blocks"]["h0"][0])
    assert fm.snapshot()["expanders"][1]["link"]["tenants"]["d0"][
        "bytes_total"] == 4096
    return observed(fm)


def new_allocations_avoid_failed_expander(pk):
    fm, host = make_pooled(pk)
    buf, _ = make_buffer(pk, host)
    assert set(buf.lmb_placement()) == {0}
    fm.inject_failure(expander_id=0)
    for p in buf.append_pages(8):
        buf.write(p, pk.full((8, 8), 7.0))
    assert set(buf.lmb_placement()) == {1}
    buf.check_invariants()
    assert fm.snapshot()["expanders"][1]["link"]["tenants"]["d0"][
        "bytes_total"] > 0
    return observed(fm, buf)


def meter_fallback_prefers_healthy_expander(pk):
    fm, _ = pk.core.make_default_fabric(pool_gib=1, spare=True)
    fm.register_device(pk.DeviceInfo("d0", pk.DeviceClass.PCIE))
    fm.inject_failure()
    fm.meter_transfer("d0", 4096)
    snap = fm.snapshot()
    assert snap["expanders"][1]["link"]["tenants"]["d0"][
        "bytes_total"] == 4096
    assert snap["link"]["tenants"]["d0"]["bytes_total"] == 4096
    return observed(fm)


def failover_regrants_stay_usable_within_quota(pk):
    fm, host = make_pooled(pk)
    buf, _ = make_buffer(pk, host)
    held = fm.held_bytes("h0")
    fm.set_quota("h0", held)
    fm.inject_failure(expander_id=0)
    assert fm.held_bytes("h0") == held
    for p in buf.append_pages(8):
        buf.write(p, pk.full((8, 8), 9.0))
    assert set(buf.lmb_placement()) == {1}
    assert fm.held_bytes("h0") == held
    buf.check_invariants()
    return observed(fm, buf)


def partial_failure_only_invalidates_dead_pages(pk):
    fm, host = make_pooled(pk)
    buf, pages = make_buffer(pk, host)
    lmb = lmb_pages_of(buf, pages)
    half = lmb[:len(lmb) // 2]
    buf.migrate_pages(half, 1)
    fm.inject_failure(expander_id=0)
    assert fm.healthy
    buf.check_invariants()
    for p in half:
        assert buf.page_expander(p) == 1
        np.testing.assert_array_equal(np.asarray(buf.read(p)),
                                      np.full((8, 8), float(p + 1)))
    assert all(buf.page_expander(p) in (None, 1) for p in lmb[len(half):])
    return observed(fm, buf)


def pooled_block_ids_never_collide(pk):
    fm, host = make_pooled(pk, n_expanders=3)
    blocks = []
    for eid in range(3):
        a = host.alloc("d0", 4096, expander_id=eid)
        assert host.expander_of(a.mmid) == eid
        blocks.append(host.allocator.region(a.mmid).block_id)
    assert len(set(blocks)) == 3
    assert [b // pk.BLOCK_ID_STRIDE for b in blocks] == [0, 1, 2]
    return {"blocks": blocks, **observed(fm)}


def placement_prefers_least_loaded_link(pk):
    fm, host = make_pooled(pk)
    a0 = host.alloc("d0", 4096, expander_id=0)
    for _ in range(50):
        host.meter_transfer("d0", 1 << 20, mmid=a0.mmid)
    grant = fm.request_block("h0")
    assert grant.expander_id == 1 and fm.expander_of(grant.block_id) == 1
    return {"grant": (grant.block_id, grant.expander_id), **observed(fm)}


CASES = [preserves_contents, regrants_iommu_entries, conserves_metered_bytes,
         stops_cleanly_when_target_full, last_expander_failure_degrades,
         failover_purges_stale_access_entries,
         parameterless_failure_targets_a_healthy_expander,
         engine_rejects_foreign_buffer, idempotent_toward_target,
         heat_ranks_hotter_pages_higher, engine_noop_below_threshold,
         engine_migrates_hot_pages_off_saturated_link,
         failover_replays_bw_shares_onto_standby,
         new_allocations_avoid_failed_expander,
         meter_fallback_prefers_healthy_expander,
         failover_regrants_stay_usable_within_quota,
         partial_failure_only_invalidates_dead_pages,
         pooled_block_ids_never_collide,
         placement_prefers_least_loaded_link]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_migration_twin(modelling_reference, case):
    jres, tres = (case(PKGS[name]) for name in ("jax", "torch"))
    assert tres == jres


@pytest.mark.parametrize("seed", range(4))
def test_plan_rebalance_equals_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        n_dev, n_exp = int(rng.integers(1, 12)), int(rng.integers(1, 5))
        demands = rng.uniform(1e9, 12e9, n_dev).tolist()
        placement = rng.integers(0, n_exp, n_dev).tolist()
        alive = sorted(set(rng.integers(0, n_exp, 2).tolist()))
        for kw in ({}, {"saturation_threshold": 0.3}, {"alive": alive}):
            got = tqos.plan_rebalance(demands, placement, n_exp, 30e9, **kw)
            assert got == jqos.plan_rebalance(demands, placement, n_exp,
                                              30e9, **kw)
            assert len(got) == n_dev
    for bad in (([1e9], [0, 0], 2, 30e9), ([1e9], [0], 2, 30e9, 0.7, []),
                ([1e9], [0], 2, 30e9, 0.7, [5])):
        with pytest.raises(ValueError) as jexc:
            jqos.plan_rebalance(*bad)
        with pytest.raises(ValueError) as texc:
            tqos.plan_rebalance(*bad)
        assert str(texc.value) == str(jexc.value)


# ------------------------------------------- serve sweep with migration
def migrating_sweep(pk, jax_params, policy):
    """serve_sweep's trace on two expanders, one ``MigrationEngine`` round
    after every engine step (``run_sweep``'s own loop around a wrapped
    ``step``); returns each round's report and LMB page placement, and
    what the run left."""
    arch = "qwen2-1.5b"
    system = pk.core.system_for("tpu0", host_id="h0", n_expanders=2,
                                pool_gib=1, page_bytes=4096,
                                metrics=pk.Metrics())
    clock = pk.serve.VirtualClock()
    ecfg = pk.serve.EngineConfig(decode_slots=4, max_seq_len=64,
                                 page_tokens=8, onboard_pages=6,
                                 prefill_bucket=16, round_time_s=2e-3)
    if pk.serve is jserve:
        eng = jserve.ServeEngine(
            jbuild_model(jget_config(arch).reduced(), JFlags(remat=False)),
            jax_params, system, ecfg, clock=clock)
    else:
        eng = tserve.ServeEngine(
            build_model(get_config(arch).reduced(), Flags(remat=False),
                        device="cpu"),
            params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                     jax_params),
                              device="cpu"),
            system, ecfg, device_id="tpu0", clock=clock, device="cpu")
    mig = pk.qos.MigrationEngine(system, policy(pk.qos))
    mig.register(eng.kv.buf)
    reports, step = [], eng.step

    def step_then_migrate():
        out = step()
        reports.append((dataclasses.asdict(mig.run_once()),
                        eng.kv.buf.lmb_placement()))
        eng.kv.buf.check_invariants()
        return out

    eng.step = step_then_migrate
    tenants = [pk.serve.TenantLoad(
        name, rate_rps=150.0, n_requests=12, process=process, burst_size=6,
        prompt_tokens=(12, 28), max_new_tokens=(4, 8))
        for name, process in (("steady", "poisson"), ("bursty", "bursty"))]
    trace = pk.serve.build_trace(
        tenants, vocab_size=get_config(arch).reduced().vocab_size, seed=0)
    report = pk.serve.run_sweep(eng, trace, clock)
    return {"reports": reports, "totals": report.totals,
            "per_tenant": report.per_tenant, "mig": mig.stats(),
            "op_bytes": system.fm.op_bytes(),
            "journal": [(j.op, j.detail) for j in system.fm.journal],
            "streams": {r.req_id: r.out_tokens
                        for r in eng.requests.values()}}


@pytest.fixture(scope="module")
def jax_params():
    cfg = jget_config("qwen2-1.5b").reduced()
    return jbuild_model(cfg, JFlags(remat=False)).init(jax.random.key(0))


@pytest.mark.parametrize("policy", [
    lambda q: q.MigrationPolicy(),
    lambda q: q.MigrationPolicy(saturation_threshold=0.3, min_gap=0.05,
                                max_pages_per_round=3, min_heat=0.0),
], ids=["default", "eager"])
def test_serve_sweep_with_migration_in_lockstep(modelling_reference,
                                                jax_params, policy):
    jres, tres = (migrating_sweep(PKGS[name], jax_params, policy)
                  for name in ("jax", "torch"))
    for key in jres:
        assert tres[key] == jres[key], key
    assert tres["totals"]["done"] == 24
    assert tres["mig"]["pages_moved"] > 0
    assert sum(r["triggered"] for r, _ in tres["reports"]) > 0
    # every KV page starts on expander 0; migration homed some on 1
    assert any(place.get(1, 0) > 0 for _, place in tres["reports"])
