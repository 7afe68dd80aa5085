"""Trace-driven continuous-batching load harness for the serve engine.

The evaluation bed for every "LMB keeps DRAM-starved serving minimally
impacted" claim: seeded multi-tenant arrival processes (Poisson and
bursty, from :func:`repro_torch.sim.workload.arrival_times`) produce a TRACE —
a time-ordered list of :class:`~repro_torch.serve.engine.SubmitSpec` — which
:func:`run_sweep` replays against a :class:`~repro_torch.serve.engine.
ServeEngine` on a virtual clock.  Mixed prefill+decode pressure,
admission, KV prefetch overlap, and preemption all run together under
sustained load, which is exactly where CXL load-latency curves bend.

Two rules keep results honest and reproducible:

  * **No harness-local timing.**  Per-tenant TTFT and inter-token
    latency come straight out of ``ServeEngine.stats()["latency"]``
    (the ``serve.ttft.*`` / ``serve.itl.*`` histograms); the harness
    only builds the report table from that snapshot.
  * **Virtual time.**  The engine is driven with a :class:`VirtualClock`
    and a pinned ``EngineConfig.round_time_s``, so every latency figure
    is a modeled quantity — identical on any machine, for a given
    trace seed.

Typical use (the ``serve_sweep`` benchmark scenario)::

    trace = build_trace([TenantLoad("gold", rate_rps=200, n_requests=32),
                         TenantLoad("burst", rate_rps=200, n_requests=32,
                                    process="bursty")],
                        vocab_size=cfg.vocab_size, seed=0)
    clock = VirtualClock()
    eng = ServeEngine(model, params, system,
                      EngineConfig(round_time_s=2e-3, ...), clock=clock)
    report = run_sweep(eng, trace, clock)
    print(report.table())
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.engine import ServeEngine, SubmitSpec
from repro_torch.sim.workload import arrival_times


class VirtualClock:
    """A monotonic virtual timebase the harness advances explicitly.

    Injected as ``ServeEngine(..., clock=clock)`` so every request
    timestamp (arrival, TTFT, inter-token, completion) is a modeled
    virtual-time quantity: machine-independent and exactly reproducible
    for a fixed trace.
    """

    def __init__(self, t0: float = 0.0):
        self._now = float(t0)

    def __call__(self) -> float:
        return self._now

    @property
    def now(self) -> float:
        return self._now

    def advance(self, dt_s: float) -> None:
        if dt_s < 0:
            raise ValueError("virtual time cannot run backwards")
        self._now += dt_s

    def advance_to(self, t_s: float) -> None:
        """Jump forward to ``t_s`` (no-op if already past it)."""
        self._now = max(self._now, t_s)


@dataclasses.dataclass(frozen=True)
class TenantLoad:
    """One tenant's offered load: arrival process + request shape.

    All draws are seeded per tenant (trace seed + tenant name), so
    adding a tenant to a sweep never perturbs another tenant's stream.
    """

    name: str
    #: mean request arrival rate (requests/second of virtual time)
    rate_rps: float
    n_requests: int
    #: "poisson" (i.i.d. exponential gaps) or "bursty" (on/off bursts
    #: at burst_factor x the mean rate; same long-run offered load)
    process: str = "poisson"
    burst_size: int = 8
    burst_factor: float = 10.0
    #: uniform [lo, hi] prompt length in tokens
    prompt_tokens: tuple = (8, 24)
    #: uniform [lo, hi] decode length in tokens
    max_new_tokens: tuple = (4, 8)
    #: optional per-request SLO deadline stamped on every SubmitSpec
    slo_deadline_s: Optional[float] = None
    #: optional hard deadline (seconds from arrival) stamped on every
    #: SubmitSpec — expired requests are cancelled by the engine
    deadline_s: Optional[float] = None


def build_trace(tenants: Sequence[TenantLoad], *, vocab_size: int,
                seed: int = 0, t0: float = 0.0) -> List[SubmitSpec]:
    """Merge every tenant's seeded arrival stream into one time-ordered
    trace of typed submissions.

    Deterministic: same ``(tenants, vocab_size, seed)`` -> byte-identical
    trace (prompt token ids included).  Ties on arrival time break by
    tenant name then per-tenant index, so the merge order is stable too.
    """
    events = []
    for tl in tenants:
        # independent per-tenant stream: seed derived from (seed, name)
        tseed = np.random.SeedSequence(
            [seed, *[ord(c) for c in tl.name]])
        seeds = tseed.generate_state(2)
        times = arrival_times(
            tl.n_requests, tl.rate_rps, process=tl.process,
            burst_size=tl.burst_size, burst_factor=tl.burst_factor,
            seed=int(seeds[0]), t0=t0)
        rng = np.random.default_rng(int(seeds[1]))
        p_lo, p_hi = tl.prompt_tokens
        m_lo, m_hi = tl.max_new_tokens
        for i, t in enumerate(times):
            plen = int(rng.integers(p_lo, p_hi + 1))
            events.append((float(t), tl.name, i, SubmitSpec(
                prompt=rng.integers(0, vocab_size, plen),
                max_new_tokens=int(rng.integers(m_lo, m_hi + 1)),
                tenant=tl.name,
                arrival_time_s=float(t),
                slo_deadline_s=tl.slo_deadline_s,
                deadline_s=tl.deadline_s)))
    events.sort(key=lambda e: (e[0], e[1], e[2]))
    return [spec for *_key, spec in events]


@dataclasses.dataclass
class SweepReport:
    """What one sweep run measured — all latency figures sourced from
    ``ServeEngine.stats()["latency"]``, never harness-local timing."""

    #: tenant -> {ttft_p50_s, ttft_p99_s, itl_p50_s, itl_p99_s, done, ...}
    per_tenant: Dict[str, dict]
    #: engine + fabric roll-up for the whole run
    totals: dict
    #: the full engine stats snapshot the report was built from
    engine_stats: dict = dataclasses.field(repr=False, default_factory=dict)

    def table(self) -> str:
        """Human-readable per-tenant latency table (ms)."""
        hdr = (f"{'tenant':<12}{'done':>6}{'shed':>6}{'ttft_p50':>10}"
               f"{'ttft_p99':>10}{'itl_p50':>9}{'itl_p99':>9}")
        lines = [hdr]
        for name, row in sorted(self.per_tenant.items()):
            lines.append(
                f"{name:<12}{row['done']:>6}{row['shed']:>6}"
                f"{row['ttft_p50_s'] * 1e3:>9.2f}m"
                f"{row['ttft_p99_s'] * 1e3:>9.2f}m"
                f"{row['itl_p50_s'] * 1e3:>8.2f}m"
                f"{row['itl_p99_s'] * 1e3:>8.2f}m")
        return "\n".join(lines)


def _tenant_rows(engine: ServeEngine) -> Dict[str, dict]:
    """Per-tenant latency rows from the engine's unified registry
    histograms (``serve.ttft.<tenant>`` / ``serve.itl.<tenant>``)."""
    lat = engine.stats()["latency"]
    tenants = sorted({name.split(".", 2)[2] for name in lat})
    shed_by_tenant: Dict[str, int] = {}
    done_by_tenant: Dict[str, int] = {}
    cancelled_by_tenant: Dict[str, int] = {}
    for req in engine.requests.values():
        if req.state == "shed":
            shed_by_tenant[req.tenant] = shed_by_tenant.get(req.tenant,
                                                            0) + 1
        elif req.state == "done":
            done_by_tenant[req.tenant] = done_by_tenant.get(req.tenant,
                                                            0) + 1
        elif req.state == "cancelled":
            cancelled_by_tenant[req.tenant] = cancelled_by_tenant.get(
                req.tenant, 0) + 1
    rows = {}
    for t in tenants:
        ttft = lat.get(f"serve.ttft.{t}")
        itl = lat.get(f"serve.itl.{t}")
        rows[t] = {
            "done": done_by_tenant.get(t, 0),
            "shed": shed_by_tenant.get(t, 0),
            "cancelled": cancelled_by_tenant.get(t, 0),
            "ttft_count": ttft["count"] if ttft else 0,
            "ttft_p50_s": ttft["p50"] if ttft else 0.0,
            "ttft_p99_s": ttft["p99"] if ttft else 0.0,
            "itl_count": itl["count"] if itl else 0,
            "itl_p50_s": itl["p50"] if itl else 0.0,
            "itl_p99_s": itl["p99"] if itl else 0.0,
        }
    return rows


def run_sweep(engine: ServeEngine, trace: Sequence[SubmitSpec],
              clock: VirtualClock, *, round_s: Optional[float] = None,
              max_rounds: int = 100_000,
              drain_idle_gaps: bool = False) -> SweepReport:
    """Replay a trace against the engine on a virtual clock.

    Open-loop: each round releases every arrival whose timestamp is due,
    runs one engine step, then advances virtual time by the engine's
    pinned round duration (``EngineConfig.round_time_s``, overridable
    with ``round_s``).  When the engine drains before the trace does,
    the clock jumps to the next arrival instead of spinning empty
    rounds.  Runs until the trace is exhausted and the engine is idle
    (or ``max_rounds``, a runaway guard).

    ``drain_idle_gaps``: also advance the fabric's link clock across
    those idle jumps.  Off by default — it would let links drain (and is
    therefore visible in exposed-wait figures) — but chaos runs need it
    so a :class:`~repro_torch.core.faults.FaultInjector`'s event clock tracks
    virtual time through quiet stretches of the trace.
    """
    if round_s is None:
        round_s = engine.ecfg.round_time_s
    if round_s is None or round_s <= 0:
        raise ValueError(
            "run_sweep needs a positive virtual round duration: set "
            "EngineConfig.round_time_s or pass round_s=")
    trace = list(trace)
    for spec in trace:
        if spec.arrival_time_s is None:
            raise ValueError("trace entries need arrival_time_s "
                             "(build_trace stamps them)")
    i, rounds = 0, 0
    peak_concurrent = 0
    peak_lmb_pages = 0
    while i < len(trace) or engine.waiting or engine.active:
        if rounds >= max_rounds:
            raise RuntimeError(
                f"sweep did not drain in {max_rounds} rounds "
                f"({len(engine.waiting)} waiting, {len(engine.active)} "
                "active) — raise max_rounds or lower the offered load")
        while i < len(trace) and trace[i].arrival_time_s <= clock.now:
            engine.submit(trace[i])
            i += 1
        if not (engine.waiting or engine.active):
            gap = trace[i].arrival_time_s - clock.now
            clock.advance_to(trace[i].arrival_time_s)
            if drain_idle_gaps and gap > 0.0:
                engine._fm.advance_links(gap)
            continue
        engine.step()
        clock.advance(round_s)
        rounds += 1
        peak_concurrent = max(peak_concurrent,
                              len(engine.active) + len(engine.waiting))
        peak_lmb_pages = max(peak_lmb_pages,
                             engine.kv.lmb_resident_pages())
    st = engine.stats()
    kv = st["kv"]
    totals = {
        "rounds": rounds,
        "virtual_s": clock.now,
        "requests": len(trace),
        "done": st["done"],
        "shed": st["shed"],
        "cancelled": st["cancelled"],
        "peak_concurrent": peak_concurrent,
        "peak_lmb_resident_pages": peak_lmb_pages,
        "exposed_link_wait_s": kv["link_wait_s"],
        "hidden_link_wait_s": kv["prefetch"]["hidden_wait_s"],
        "kv_hit_ratio": kv["hit_ratio"],
        "meter_calls": st["fabric"]["meter_calls"],
    }
    return SweepReport(per_tenant=_tenant_rows(engine), totals=totals,
                       engine_stats=st)
