"""The port's serving engine against the JAX reference's on the paths of
``tests/test_serve.py`` that no other parity test reaches: preemption and
resume, prefix fork, QoS admission with shedding and SLO feedback,
deadlines (a waiting request and one in flight, and their per-tenant SLO
count), the throttle's FIFO order, and the capacity cancel when the pool
loses its expander mid-run.

Both engines serve qwen2-1.5b reduced with the reference's
``Model.init(jax.random.key(0))`` params (the port's through
``interop.params_from_numpy``), get the same ``SubmitSpec``s, each its own
virtual clock advanced at the same points, and a pinned ``round_time_s``,
so every prefetch and admission decision is the same on both.  After the
scenario the request states, token streams, cancel reasons, ``stats()``
(per-tenant SLO counters, latency histograms, KV and fabric figures
included) and ``op_bytes()`` must be equal.

Modelling mode, as in ``test_torch_serve.py``: the reference's
``backend_memory_kinds`` is patched to ``("device",)``.  The reference's
own capacity-cancel test fails on this JAX (it gathers from a
``pinned_host`` pool); in modelling mode it runs, and the twin holds the
port to it there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.offload
import repro.qos
import repro_torch.qos
from repro.configs.base import get_config as jget_config
from repro.core import system_for as jsystem_for
from repro.models import build_model as jbuild_model
from repro.models.flags import Flags as JFlags
from repro.qos.slo import Decision as JDecision
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SubmitSpec as JSubmitSpec
from repro.serve.kv_cache import PagedKVStore as JPagedKVStore
from repro_torch.configs.base import get_config
from repro_torch.core import TierExecutor, system_for
from repro_torch.core.metrics import GLOBAL_METRICS
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.models import build_model
from repro_torch.models.flags import Flags
from repro_torch.qos.slo import Decision
from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec
from repro_torch.serve.kv_cache import PagedKVStore

ARCH = "qwen2-1.5b"


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    """tests/conftest.py resets only the reference's GLOBAL_METRICS."""
    GLOBAL_METRICS.reset()
    yield


@pytest.fixture
def modelling_reference(monkeypatch):
    monkeypatch.setattr(repro.core.offload, "backend_memory_kinds",
                        lambda: ("device",))


@pytest.fixture(scope="module")
def jax_params():
    cfg = jget_config(ARCH).reduced()
    return jbuild_model(cfg, JFlags(remat=False)).init(jax.random.key(0))


class Clock:
    """A virtual timebase, advanced by the scenario."""

    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


class AlwaysThrottle:
    """Throttles one tenant forever and admits everyone else (the
    controller of ``test_serve.py``'s throttle test), in either package's
    ``Decision``."""

    def __init__(self, victim, decision):
        self.victim, self.decision = victim, decision

    def decide(self, tenant):
        return (self.decision.THROTTLE if tenant == self.victim
                else self.decision.ADMIT)

    def observe(self, tenant, latency_s):
        pass

    def release(self, tenant):
        pass

    def record_cancel(self, tenant):
        pass

    def snapshot(self):
        return {}


class Side:
    """One package's engine, system, clock and request ids."""

    def __init__(self, pkg, jax_params, qos=None, **ecfg):
        kw = dict(decode_slots=2, max_seq_len=64, page_tokens=8,
                  onboard_pages=8, round_time_s=1e-3)
        kw.update(ecfg)
        self.clock = Clock()
        self.rids = []
        if pkg == "jax":
            self.system = jsystem_for("dev0", host_id="h0", pool_gib=1,
                                      page_bytes=4096)
            self.spec = JSubmitSpec
            self.eng = JServeEngine(
                jbuild_model(jget_config(ARCH).reduced(),
                             JFlags(remat=False)),
                jax_params, self.system, JEngineConfig(**kw),
                device_id="dev0", qos=qos, clock=self.clock)
        else:
            self.system = system_for("dev0", host_id="h0", pool_gib=1,
                                     page_bytes=4096)
            self.spec = SubmitSpec
            self.eng = ServeEngine(
                build_model(get_config(ARCH).reduced(), Flags(remat=False),
                            device="cpu"),
                params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         jax_params),
                                  device="cpu"),
                self.system, EngineConfig(**kw), device_id="dev0", qos=qos,
                clock=self.clock, device="cpu")

    def submit(self, prompt, max_new_tokens, **kw):
        rid = self.eng.submit(self.spec(prompt=prompt,
                                        max_new_tokens=max_new_tokens, **kw))
        self.rids.append(rid)
        return rid

    def req(self, rid):
        return self.eng.requests[rid]


def _controller(pkg, tenants):
    """An SLO admission controller of ``pkg`` with ``tenants``:
    {name: (SLOTarget kwargs, demand_Bps)}."""
    qos = repro.qos if pkg == "jax" else repro_torch.qos
    ctrl = qos.AdmissionController(link_bandwidth_Bps=10e9)
    for name, (target, demand) in tenants.items():
        ctrl.register(name, target=qos.SLOTarget(**target),
                      demand_Bps=demand, base_latency_s=0.01)
    return ctrl


# ---------------------------------------------------------------- scenarios
# Each drives one side; the test runs it on both and compares.  The
# assertions inside are test_serve.py's, so each twin shows its path ran.
def preempt_resume(side):
    rng = np.random.default_rng(2)
    r1 = side.submit(rng.integers(0, 100, 10), 8)
    r2 = side.submit(rng.integers(0, 100, 10), 8)
    side.eng.step()
    assert side.req(r1).state == "active"
    slot = next(s for s, r in side.eng.active.items() if r.req_id == r1)
    side.eng.preempt(slot)
    assert side.req(r1).state == "preempted"
    side.eng.run(300)
    assert side.req(r1).state == side.req(r2).state == "done"


def qos_shed_and_slo_feedback(side):
    rng = np.random.default_rng(0)
    gold = side.submit(rng.integers(0, 100, 8), 3, tenant="gold")
    abuser = side.submit(rng.integers(0, 100, 8), 3, tenant="abuser")
    side.eng.run(100)
    assert side.req(gold).state == "done"
    assert side.req(abuser).state == "shed"
    t = side.eng.stats()["qos"]["tenants"]
    assert t["abuser"]["shed_count"] == 1
    assert t["gold"]["observed_p99_s"] is not None


def deadline_expires_waiting(side):
    rng = np.random.default_rng(0)
    r1 = side.submit(rng.integers(0, 100, 10), 8)
    r2 = side.submit(rng.integers(0, 100, 10), 4, deadline_s=0.5)
    side.eng.step()
    assert side.req(r2).state == "waiting"
    side.clock.advance(1.0)
    side.eng.step()
    assert side.req(r2).state == "cancelled"
    assert side.req(r2).cancel_reason == "deadline"
    side.eng.run(200)
    assert side.req(r1).state == "done"


def deadline_cancels_mid_flight(side):
    rng = np.random.default_rng(1)
    rid = side.submit(rng.integers(0, 100, 10), 64, deadline_s=0.5)
    side.eng.step()
    assert side.req(rid).state == "active"
    side.clock.advance(1.0)
    side.eng.step()
    assert side.req(rid).state == "cancelled"
    assert side.req(rid).seq_id is None and not side.eng.active
    side.eng.kv.buf.check_invariants()


def deadline_counted_in_tenant_slo(side):
    rng = np.random.default_rng(2)
    blocker = side.submit(rng.integers(0, 100, 10), 8, tenant="gold")
    doomed = side.submit(rng.integers(0, 100, 10), 4, tenant="gold",
                         deadline_s=0.25)
    side.eng.step()
    side.clock.advance(1.0)
    side.eng.run(200)
    assert side.req(blocker).state == "done"
    assert side.req(doomed).state == "cancelled"
    assert side.eng.stats()["qos"]["tenants"]["gold"]["cancelled_count"] \
        == 1


def throttle_keeps_fifo(side):
    rng = np.random.default_rng(3)
    bad = side.submit(rng.integers(0, 100, 10), 4, tenant="starved",
                      deadline_s=2.0)
    side.submit(rng.integers(0, 100, 10), 4, tenant="good")
    g2 = side.submit(rng.integers(0, 100, 10), 4, tenant="good")
    side.eng.step()
    assert [r.req_id for r in side.eng.waiting] == [bad, g2]
    for _ in range(30):
        if not (side.eng.waiting or side.eng.active):
            break
        side.eng.step()
        side.clock.advance(0.1)
    assert side.req(bad).state == "cancelled"
    assert side.req(bad).cancel_reason == "deadline"


def capacity_cancel_when_pool_degrades(side):
    rng = np.random.default_rng(4)
    for _ in range(6):
        side.submit(rng.integers(0, 100, 20), 8)
    side.eng.step()
    side.system.inject_failure()         # the only expander dies
    side.eng.run(400)
    states = [side.req(r).state for r in side.rids]
    assert set(states) <= {"done", "cancelled"} and "cancelled" in states
    assert all(side.req(r).cancel_reason == "capacity"
               for r in side.rids if side.req(r).state == "cancelled")


SCENARIOS = {
    "preempt_resume": (preempt_resume, {}),
    "qos_shed_and_slo_feedback": (qos_shed_and_slo_feedback, {"qos": {
        "gold": ({"p99_latency_s": 10.0}, 1e9),
        "abuser": ({"p99_latency_s": 0.005, "shed_factor": 1.5}, 9.5e9)}}),
    "deadline_expires_waiting": (deadline_expires_waiting,
                                 {"decode_slots": 1}),
    "deadline_cancels_mid_flight": (deadline_cancels_mid_flight,
                                    {"decode_slots": 1}),
    "deadline_counted_in_tenant_slo": (deadline_counted_in_tenant_slo, {
        "decode_slots": 1,
        "qos": {"gold": ({"p99_latency_s": 100.0}, 1e6)}}),
    "throttle_keeps_fifo": (throttle_keeps_fifo, {"decode_slots": 1,
                                                  "qos": "throttle"}),
    "capacity_cancel_when_pool_degrades": (
        capacity_cancel_when_pool_degrades,
        {"decode_slots": 4, "onboard_pages": 4}),
}


def _qos(pkg, spec):
    if spec is None:
        return None
    if spec == "throttle":
        return AlwaysThrottle("starved",
                              JDecision if pkg == "jax" else Decision)
    return _controller(pkg, spec)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_twin(modelling_reference, jax_params, name):
    run, kw = SCENARIOS[name]
    kw = dict(kw)
    qos = kw.pop("qos", None)
    sides = [Side(pkg, jax_params, qos=_qos(pkg, qos), **kw)
             for pkg in ("jax", "torch")]
    for side in sides:
        run(side)
    jside, tside = sides
    assert tside.rids == jside.rids
    for rid in jside.rids:
        j, t = jside.req(rid), tside.req(rid)
        assert (t.state, t.cancel_reason, t.out_tokens,
                t.seq_id is None) == (j.state, j.cancel_reason,
                                      j.out_tokens, j.seq_id is None), rid
    assert tside.eng.stats() == jside.eng.stats()
    assert (tside.eng.kv.buf.host.fm.op_bytes()
            == jside.eng.kv.buf.host.fm.op_bytes())
    tside.eng.kv.buf.check_invariants()


def test_prefix_fork_twin(modelling_reference):
    """``PagedKVStore.fork`` shares a page-aligned prefix without new LMB
    bytes, the fork's appends land in fresh pages, and the source is left
    as it was: the same data, owned bytes, residency and link bytes on
    both (``test_serve.py``'s prefix-fork test, in lockstep)."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    rng = np.random.default_rng(6)
    prefix = rng.standard_normal((L, 2, 8, KV, hd)).astype(np.float32)
    more = rng.standard_normal((L, 2, 6, KV, hd)).astype(np.float32)
    sides = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            system = jsystem_for("tpu0", host_id="h0", pool_gib=1,
                                 page_bytes=4096)
            kv = JPagedKVStore(cfg=jcfg, system=system, device_id="tpu0",
                               page_tokens=4, onboard_pages=4)
            wrap = jnp.asarray
        else:
            system = system_for("tpu0", host_id="h0", pool_gib=1,
                                page_bytes=4096)
            kv = PagedKVStore(cfg=cfg, system=system, device_id="tpu0",
                              page_tokens=4, onboard_pages=4,
                              executor=TierExecutor("cpu"), device="cpu")
            wrap = functools.partial(tensor_from_numpy, device="cpu")
        sid = kv.new_seq()
        kv.append_tokens(sid, wrap(prefix))
        held = system.host().owned_bytes("tpu0")
        fork = kv.fork(sid)
        assert system.host().owned_bytes("tpu0") == held
        kv.append_tokens(fork, wrap(more))
        out = (np.asarray(kv.gather_seq(sid)),
               np.asarray(kv.gather_seq(fork)), held,
               system.host().owned_bytes("tpu0"),
               kv.seq(fork).pages, kv.buf.host.fm.op_bytes(),
               [kv.buf.tier_of(p) for p in range(kv.buf.num_pages)])
        kv.free_seq(fork)
        kv.free_seq(sid)
        kv.buf.check_invariants()
        sides.append(out + (kv.buf.host.fm.op_bytes(),))
    (js, jf, *jrest), (ts, tf, *trest) = sides
    np.testing.assert_array_equal(ts, prefix)          # source unchanged
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tf[:, :, :8], prefix)
    np.testing.assert_array_equal(tf[:, :, 8:], more)
    assert trest == jrest
