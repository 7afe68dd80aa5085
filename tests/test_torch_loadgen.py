"""The port's load harness (``serve.loadgen``) against the JAX package's.

``build_trace`` must give byte-identical traces (arrival times, prompt
ids, decode lengths, deadlines).  ``run_sweep`` then replays one trace
against the reference's ``ServeEngine`` and the port's, each on its own
``VirtualClock`` with a pinned ``round_time_s``: the ``SweepReport``s
(per-tenant rows, totals, the engine snapshot they came from), the token
streams by request id and the per-class link bytes must be equal.  The
cases are ``serve_sweep``'s and ``chaos_sweep``'s of ``benchmarks/run.py``:
pipelined and phased, hard deadlines that cancel, a zero-fault plan (which
must equal no injector at all) and a scripted CRC, brownout and link-flap
storm with and without link retries, on the fabric clock that
``drain_idle_gaps`` advances; and a model on the dense slot path (rwkv6,
``kv_prefetch=False``: the reference raises with its prefetcher on).

Weights are the reference's ``Model.init(jax.random.key(0))``, handed to
the port through ``interop.params_from_numpy``; the reference's LMB tier
runs in modelling mode (``backend_memory_kinds`` patched to
``("device",)``).  Every figure compared is virtual time or a count, so
equality is exact.  Last, ``tools/lmbtrace.py`` summarises the port's
exported trace of a sweep exactly as it does the reference's.
"""

import dataclasses
import importlib
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

import repro.core.offload
import repro.core as jcore
import repro.serve as jserve
import repro_torch.core as tcore
import repro_torch.serve as tserve
from repro.configs.base import get_config as jget_config
from repro.core.metrics import Metrics as JMetrics
from repro.models import build_model as jbuild_model
from repro.models.flags import Flags as JFlags
from repro_torch.configs.base import get_config
from repro_torch.core.metrics import GLOBAL_METRICS, Metrics
from repro_torch.interop import params_from_numpy
from repro_torch.models import build_model
from repro_torch.models.flags import Flags

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: serve_sweep's engine (benchmarks/run.py), which chaos_sweep shares
SWEEP_ECFG = dict(decode_slots=4, max_seq_len=64, page_tokens=8,
                  onboard_pages=6, prefill_bucket=16, round_time_s=2e-3)


def sweep_tenants(pkg, n=12, **kw):
    """serve_sweep's two tenants (``n`` requests each) in ``pkg``."""
    return [pkg.TenantLoad("steady", rate_rps=150.0, n_requests=n,
                           prompt_tokens=(12, 28), max_new_tokens=(4, 8),
                           **kw),
            pkg.TenantLoad("bursty", rate_rps=150.0, n_requests=n,
                           process="bursty", burst_size=6,
                           prompt_tokens=(12, 28), max_new_tokens=(4, 8),
                           **kw)]


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    """The KV stores count onboard hits and misses in each package's
    ``GLOBAL_METRICS``; tests/conftest.py resets only the reference's."""
    GLOBAL_METRICS.reset()
    yield


@pytest.fixture
def modelling_reference(monkeypatch):
    monkeypatch.setattr(repro.core.offload, "backend_memory_kinds",
                        lambda: ("device",))


@pytest.fixture(scope="module")
def params():
    """Reduced configs' reference params, and the same for the port."""
    out = {}
    for arch in ("qwen2-1.5b", "rwkv6-7b"):
        jp = jbuild_model(jget_config(arch).reduced(),
                          JFlags(remat=False)).init(jax.random.key(0))
        out[arch] = (jp, params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    return out


def engine(pkg, params, arch="qwen2-1.5b", plan=None, retry=None, **ecfg):
    """One package's engine, its system, clock and fault injector."""
    kw = dict(SWEEP_ECFG)
    kw.update(ecfg)
    core, serve = (jcore, jserve) if pkg == "jax" else (tcore, tserve)
    system = core.system_for("tpu0", host_id="h0", pool_gib=1,
                             page_bytes=4096,
                             metrics=JMetrics() if pkg == "jax"
                             else Metrics())
    injector = (system.attach_fault_injector(plan, retry=retry, seed=7)
                if plan is not None else None)
    clock = serve.VirtualClock()
    jp, tp = params[arch]
    if pkg == "jax":
        model = jbuild_model(jget_config(arch).reduced(),
                             JFlags(remat=False))
        eng = serve.ServeEngine(model, jp, system,
                                serve.EngineConfig(**kw), clock=clock)
    else:
        model = build_model(get_config(arch).reduced(), Flags(remat=False),
                            device="cpu")
        eng = serve.ServeEngine(model, tp, system, serve.EngineConfig(**kw),
                                device_id="tpu0", clock=clock, device="cpu")
    return eng, system, clock, injector


def storm_plan(core, t_end, round_s):
    """chaos_sweep's storm: a CRC-error window, a brownout, a link flap."""
    return core.FaultPlan((
        core.FaultEvent(t_s=0.1 * t_end, kind="transient",
                        duration_s=0.8 * t_end, error_rate=0.35,
                        crc_retry_cost_s=2e-6),
        core.FaultEvent(t_s=0.3 * t_end, kind="brownout",
                        duration_s=0.3 * t_end, latency_factor=4.0),
        core.FaultEvent(t_s=0.6 * t_end, kind="link_flap",
                        retrain_s=2 * round_s),
    ))


def sweep(pkg, params, tenants, *, fault=None, drain=False, arch=None,
          **ecfg):
    """Build ``pkg``'s trace of ``tenants(serve)`` and replay it; returns
    what is compared across packages."""
    core, serve = (jcore, jserve) if pkg == "jax" else (tcore, tserve)
    cfg = get_config(arch or "qwen2-1.5b").reduced()
    trace = serve.build_trace(tenants(serve), vocab_size=cfg.vocab_size,
                              seed=0)
    plan = retry = None
    if fault is not None:
        t_end = max(s.arrival_time_s for s in trace)
        plan = (core.FaultPlan() if fault == "zero"
                else storm_plan(core, t_end, SWEEP_ECFG["round_time_s"]))
        retry = {"zero": None,
                 "storm": core.RetryPolicy(link_retry_budget=100_000),
                 "storm_noretry": core.RetryPolicy(max_retries=0)}[fault]
    eng, system, clock, inj = engine(pkg, params, arch or "qwen2-1.5b",
                                     plan=plan, retry=retry, **ecfg)
    report = serve.run_sweep(eng, trace, clock, drain_idle_gaps=drain)
    engine_stats = report.engine_stats
    if pkg == "torch":
        # the port's KV stats add how each paged round read its pages
        kv = dict(engine_stats["kv"])
        rounds = [kv.pop(k) for k in ("direct_rounds", "gathered_rounds")]
        assert sum(rounds) == eng.paged_rounds
        engine_stats = dict(engine_stats, kv=kv)
    return {
        "per_tenant": report.per_tenant,
        "totals": report.totals,
        "engine_stats": engine_stats,
        "table": report.table(),
        "streams": {r.req_id: (r.state, r.cancel_reason, r.out_tokens)
                    for r in eng.requests.values()},
        "op_bytes": system.fm.op_bytes(),
        "link_wait_s": eng.kv.buf.link_wait_s,
        "healthy": system.fm.healthy,
        "faults": inj.counters() if inj is not None else None,
    }


def test_engine_config_accepts_the_reference_keywords():
    """The reference's sweep callers pass ``prefill_bucket`` (a no-op in
    both packages); both configs built from the same keywords are equal,
    defaults included."""
    for kw in ({}, dict(decode_slots=2, max_seq_len=64, page_tokens=8,
                        onboard_pages=6, prefill_bucket=16,
                        round_time_s=2e-3),
               dict(SWEEP_ECFG, pipeline=False, kv_prefetch=False)):
        assert dataclasses.asdict(tserve.EngineConfig(**kw)) == \
            dataclasses.asdict(jserve.EngineConfig(**kw))
    assert tserve.EngineConfig().prefill_bucket == 64


@pytest.mark.parametrize("tenants", [
    lambda s: [s.TenantLoad("p", rate_rps=80.0, n_requests=40)],
    lambda s: [s.TenantLoad("b", rate_rps=80.0, n_requests=40,
                            process="bursty", burst_size=5,
                            burst_factor=6.0, prompt_tokens=(3, 50),
                            max_new_tokens=(1, 9), deadline_s=0.25)],
    lambda s: sweep_tenants(s, n=16, slo_deadline_s=0.04) + [
        s.TenantLoad("gold", rate_rps=7.5, n_requests=9,
                     prompt_tokens=(16, 256), max_new_tokens=(16, 32))],
], ids=["poisson", "bursty", "mixed"])
def test_build_trace_is_byte_identical(tenants):
    traces = [pkg.build_trace(tenants(pkg), vocab_size=151936, seed=3,
                              t0=0.5) for pkg in (jserve, tserve)]
    assert len(traces[0]) == len(traces[1]) > 0
    for j, t in zip(*traces):
        assert type(t).__module__ == "repro_torch.serve.engine"
        assert t.prompt.dtype == j.prompt.dtype
        assert t.prompt.tobytes() == j.prompt.tobytes()
        for f in ("max_new_tokens", "tenant", "arrival_time_s",
                  "slo_deadline_s", "deadline_s"):
            assert getattr(t, f) == getattr(j, f), f


SWEEPS = {
    "pipelined": dict(tenants=sweep_tenants),
    "phased": dict(tenants=sweep_tenants, pipeline=False),
    # test_loadgen's tight deadline: about one round, so requests die
    "deadlines": dict(tenants=lambda s: [s.TenantLoad(
        "tight", rate_rps=200.0, n_requests=6, prompt_tokens=(8, 12),
        max_new_tokens=(24, 32), deadline_s=1e-3)], decode_slots=1),
    "zero_fault_plan": dict(
        tenants=lambda s: sweep_tenants(s, deadline_s=5.0), fault="zero",
        drain=True),
    "storm_with_retries": dict(
        tenants=lambda s: sweep_tenants(s, deadline_s=5.0), fault="storm",
        drain=True),
    "storm_without_retries": dict(
        tenants=lambda s: sweep_tenants(s, deadline_s=5.0),
        fault="storm_noretry", drain=True),
    # the dense slot path; the reference raises with its prefetcher on
    "rwkv6_dense_slots": dict(
        tenants=lambda s: sweep_tenants(s, n=4), arch="rwkv6-7b",
        kv_prefetch=False),
}


@pytest.mark.parametrize("name", list(SWEEPS))
def test_run_sweep_equals_reference(modelling_reference, params, name):
    kw = dict(SWEEPS[name])
    tenants = kw.pop("tenants")
    jres, tres = (sweep(pkg, params, tenants, **kw)
                  for pkg in ("jax", "torch"))
    for key in jres:
        assert tres[key] == jres[key], key
    tot = tres["totals"]
    assert tot["done"] + tot["cancelled"] + tot["shed"] == tot["requests"]
    if name == "deadlines":
        assert tot["cancelled"] > 0
    elif name == "storm_with_retries":
        assert tres["faults"]["retries"] > 0
        assert tres["faults"]["retry_bytes"] == tres["op_bytes"]["retry"]
        assert tot["done"] == tot["requests"]
    elif name == "storm_without_retries":
        assert tres["faults"]["escalations"] > 0
        assert tot["done"] < tot["requests"]
    else:
        assert tot["done"] == tot["requests"]
    if name == "zero_fault_plan":
        GLOBAL_METRICS.reset()
        bare = sweep("torch", params, tenants, drain=True)
        assert (bare["streams"], bare["op_bytes"]) == \
            (tres["streams"], tres["op_bytes"])
    if name == "rwkv6_dense_slots":
        assert tres["engine_stats"]["decode_path"] == "dense"
    elif name != "deadlines":        # one slot of short prompts: no spill
        assert sum(tres["op_bytes"].values()) > 0


def test_pipelined_equals_phased_with_less_exposed_wait(params):
    """The pipelining contract, on the port alone: the same streams from
    both step orders, and strictly less exposed link wait pipelined."""
    pipe, phased = (sweep("torch", params, sweep_tenants, pipeline=p)
                    for p in (True, False))
    assert pipe["streams"] == phased["streams"]
    assert pipe["link_wait_s"] < phased["link_wait_s"]


#: spans the port's serving path records and the reference's does not:
#: the round's phases, each staged call, the KV store's batched accesses
#: and the executor's bursts (the reference's executor records into the
#: disabled global tracer); the reference's ``decode.paged`` event is the
#: port's ``serve.decode`` span
PORT_ONLY_SPANS = {
    "serve.admit", "serve.prefill", "serve.decode", "serve.readback",
    "serve.tail", "staged.eager", "staged.capture", "staged.replay",
    "staged.regrow", "kv.decode_view", "kv.commit_decode",
    "exec.read_pages", "exec.write_pages"}


def test_lmbtrace_reads_the_ports_trace(modelling_reference, params,
                                        tmp_path):
    """A traced sweep exported by each package's ``obs.export`` gives
    ``tools/lmbtrace.py`` the same summary: span names and counts, link
    bytes and modelled seconds by class, per-tenant link waits.  The
    port's names are the reference's, with ``decode.paged`` counted as
    ``serve.decode``, and the spans it alone records
    (``PORT_ONLY_SPANS``)."""
    from repro.obs.export import write_chrome_trace as jwrite
    from repro_torch.obs.export import write_chrome_trace
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        lmbtrace = importlib.import_module("lmbtrace")
    finally:
        sys.path.remove(str(ROOT / "tools"))
    summaries = []
    for pkg, write in (("jax", jwrite), ("torch", write_chrome_trace)):
        serve = jserve if pkg == "jax" else tserve
        trace = serve.build_trace(sweep_tenants(serve, n=4),
                                  vocab_size=get_config(
                                      "qwen2-1.5b").reduced().vocab_size,
                                  seed=0)
        eng, _, clock, _ = engine(pkg, params, trace=True)
        serve.run_sweep(eng, trace, clock)
        path = tmp_path / f"{pkg}.json"
        write(eng.trace.spans(), str(path))
        summaries.append(lmbtrace.summarize(lmbtrace._load(str(path))))
        out = subprocess.run(
            [sys.executable, str(ROOT / "tools" / "lmbtrace.py"), "summary",
             str(path)], capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert "link.xfer" in out.stdout and "serve.round" in out.stdout
    jsum, tsum = summaries
    names = dict(tsum.pop("names"))
    jnames = dict(jsum.pop("names"))
    assert names["serve.decode"] == jnames.pop("decode.paged") > 0
    port_only = {k: names.pop(k) for k in PORT_ONLY_SPANS if k in names}
    assert names == jnames
    assert tsum.pop("spans") == jsum.pop("spans") - port_only[
        "serve.decode"] + sum(port_only.values())
    assert tsum == jsum
    assert names["serve.round"] > 0 and tsum["op_bytes"]
