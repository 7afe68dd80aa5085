"""Continuous-batching serving engine with LMB-backed KV capacity.

The scheduler runs fixed decode slots (the jitted decode step's batch);
waiting/preempted requests' KV parks in the LMB pool via PagedKVStore.
The admission limit is pool capacity — onboard (HBM) only bounds the
number of *simultaneously decoding* requests, which is the paper's thesis
applied to serving.

Flow per request: admit -> prefill -> decode in a slot
-> [optional preempt: KV pages out to LMB; resume: pages back] -> finish.
Swap decisions consult the tier cost model; all movement is metered by
repro_torch.core.metrics.

Multi-tenant QoS (repro_torch.qos): requests carry a tenant id; when the engine
is built with an AdmissionController, every seating decision routes
through it — ADMIT seats the request, THROTTLE leaves it queued for a
later round, SHED rejects it outright (state "shed").  Completed request
latencies feed the tenant's SLO tracker, closing the loop.

PyTorch port of ``repro.serve.engine``: where the reference stages its
prefill and decode steps with ``jax.jit``, the port captures them as CUDA
graphs (``serve/staged.py``): prefill one graph per prompt length, all
writing into one static prefill cache; the paged step one graph per
batch size; the dense slot step one graph per decode slot, each slot
holding a static cache that a request's prefilled cache is copied into
when it is seated.  ``staged=False`` runs prefill and both steps eagerly.
Greedy argmax runs on the device with one host sync per prefill, one per
paged round, and one per request and step on the dense slot path, as the
reference's; the engine runs on the model's device (CUDA unless built
with ``device="cpu"``).  ``submit`` takes a :class:`SubmitSpec`; the
reference's deprecated ``submit(prompt, max_new_tokens=, tenant=)`` works
too, with a ``DeprecationWarning``.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.api import LMBHost
from repro_torch.core.client import LMBSystem
from repro_torch.core.pool import OutOfMemory
from repro_torch.devices import resolve_device
from repro_torch.models.zoo import Model
from repro_torch.obs.trace import DEFAULT_RING_CAPACITY, NULL_SPAN, SpanTracer
from repro_torch.qos.slo import AdmissionController, Decision
from repro_torch.serve.kv_cache import PagedKVStore
from repro_torch.serve.staged import StagedPrefill, StagedSlots, StagedStep


@dataclasses.dataclass(frozen=True)
class SubmitSpec:
    """Typed submission: everything one request brings to the engine.

    Replaces the growing ``submit(prompt, max_new_tokens=..., ...)``
    positional/kwarg surface — load generators build these up front
    (``arrival_time_s`` stamps when the request entered the system, in
    the engine clock's timebase, so queueing delay counts toward TTFT),
    and policy code reads ``slo_deadline_s`` instead of re-deriving
    per-tenant targets."""

    prompt: np.ndarray                 # [S] int32 token ids
    max_new_tokens: int = 16
    tenant: str = "default"
    #: arrival timestamp in the engine clock's timebase; ``None`` means
    #: "now" (the clock value at submit time).  A trace replay sets it
    #: so admission/queueing delay is charged to TTFT.
    arrival_time_s: Optional[float] = None
    #: per-request SLO deadline (seconds from arrival to completion);
    #: recorded on the request for policy layers, not enforced here
    slo_deadline_s: Optional[float] = None
    #: hard deadline (seconds from arrival): a request not finished by
    #: ``arrival + deadline_s`` is CANCELLED — removed from the queue or
    #: pulled out of its decode slot mid-flight, its KV pages freed, and
    #: counted per-tenant (``cancelled_count`` in the SLO snapshot).
    #: ``None`` means no enforcement (the pre-deadline behavior).
    deadline_s: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "prompt",
                           np.asarray(self.prompt, np.int32))
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.deadline_s is not None and self.deadline_s < 0:
            raise ValueError("deadline_s must be >= 0")


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int = 16
    tenant: str = "default"
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    seq_id: Optional[int] = None
    state: str = "waiting"     # waiting|active|preempted|done|shed|cancelled
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    last_token_at: Optional[float] = None
    done_at: Optional[float] = None
    slo_deadline_s: Optional[float] = None
    #: absolute engine-clock instant after which the request is cancelled
    deadline_s: Optional[float] = None
    #: why a cancelled request was cancelled ("deadline" | "capacity")
    cancel_reason: Optional[str] = None


@dataclasses.dataclass
class EngineConfig:
    decode_slots: int = 4
    max_seq_len: int = 256
    page_tokens: int = 32
    onboard_pages: int = 32            # HBM-tier KV budget
    #: accepted for the reference's keywords and has no effect in either
    #: package: the reference pads a prompt to this bucket, then prefills
    #: ``toks[:, :len(prompt)]``, so every prompt runs at its own length
    prefill_bucket: int = 64
    #: feed each active sequence's next-decode page list to the KV
    #: store's prefetcher every batch round (exact future knowledge,
    #: moved as coalesced bursts).  Pure performance knob: tokens are
    #: identical with it off.
    kv_prefetch: bool = True
    #: pages of prefetch lookahead per round (0 disables the prefetcher
    #: outright, not just the engine-fed schedule)
    kv_prefetch_depth: int = 2
    #: initial compute-window estimate for the overlap scheduler; the
    #: engine refines it with measured decode-round times
    kv_compute_window_s: float = 1e-3
    #: pipeline the step: admission and next-round KV prefetch run at
    #: the END of each decode round, while the round's compute window
    #: is still draining the expander links (FabricManager.advance_links
    #: models the drain).  Tokens are byte-identical to the phased
    #: (admit -> prefetch -> decode) order; only the modeled exposed
    #: link wait changes (strictly down — bursts issue into a drained
    #: link under an open overlap window).
    pipeline: bool = True
    #: virtual decode-round duration: when set, the engine drains links
    #: and sizes the overlap window with this fixed figure instead of
    #: measured wall time, so a sweep driven by a virtual clock is
    #: machine-independent and seed-reproducible
    round_time_s: Optional[float] = None
    #: decode straight from the paged KV pool: every round runs ONE
    #: batched paged-attention step over all active slots against a
    #: DecodeView of the pool (union of the actives' pages, one
    #: coalesced read burst) instead of a per-request dense slot cache
    #: filled by host-side gather_seq swap-in.  Token streams are
    #: byte-identical to the dense path (the decode dispatcher's
    #: numerics mirror attn_decode bitwise).  Automatically falls back
    #: to the dense path for architectures the paged kernel does not
    #: cover (SWA rings, RWKV/HYBRID state, encoder-decoder).
    paged_decode: bool = True
    #: record spans (serve rounds, TTFT/token events, the KV data path)
    #: into a private tracer attached to the engine's fabric — unless
    #: the fabric already carries an enabled tracer (LMBSystem with
    #: ObsSpec.trace, or benchmarks' global tracer), which is reused
    trace: bool = False
    #: ring capacity of the engine-minted tracer
    trace_capacity: int = DEFAULT_RING_CAPACITY


def check_servable(cfg) -> None:
    """Raise ``ValueError`` for a model the engine cannot serve.

    An encoder-decoder (seamless-m4t) prefills from source frame
    embeddings, ``batch["src_emb"]``, and a request carries only its
    prompt's tokens.  The reference engine passes the tokens alone
    (``repro/serve/engine.py:257-258``) and fails on its first step with
    ``KeyError: 'src_emb'``; the port adds no feature the reference lacks,
    so it refuses the model when the engine is built."""
    if cfg.encoder_decoder:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder model: ServeEngine feeds a "
            "request's prompt tokens only, and its prefill needs source "
            "embeddings (batch['src_emb']); the reference engine cannot "
            "feed src_emb either (its first step raises KeyError: "
            "'src_emb').  Drive it through Model.prefill and "
            "Model.decode_step instead")


class ServeEngine:
    """``lmb`` is the LMB stack the KV store pages against: an
    :class:`~repro_torch.core.client.LMBSystem` session (the client API) or a
    bare :class:`~repro_torch.core.api.LMBHost` for low-level wiring."""

    def __init__(self, model: Model, params,
                 lmb: Union[LMBSystem, LMBHost],
                 ecfg: EngineConfig, device_id: str = "gpu0",
                 qos: Optional[AdmissionController] = None,
                 clock: Optional[Callable[[], float]] = None,
                 device="cuda", staged: bool = True):
        check_servable(model.cfg)
        host = lmb.host() if isinstance(lmb, LMBSystem) else lmb
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.params = params
        self.ecfg = ecfg
        self.cfg = model.cfg
        self.qos = qos
        #: timestamp source for request latency accounting (TTFT/ITL);
        #: defaults to wall time — a load harness injects a
        #: VirtualClock so latency figures are machine-independent
        self.clock: Callable[[], float] = clock or time.monotonic
        self.shed: List[int] = []
        self.cancelled: List[int] = []
        self._tenant_live: Dict[str, int] = {}   # in-flight reqs per tenant
        self.metrics = host.metrics
        self._fm = host.fm              # link drain + placement queries
        # tracing: reuse an already-enabled fabric tracer (session/global)
        # or, when the config asks, mint one and attach it to the fabric
        # BEFORE the KV store builds its LinkedBuffer, so the whole KV
        # data path records into the same ring as the serve rounds
        self.trace: SpanTracer = host.fm.tracer
        if ecfg.trace and not self.trace.enabled:
            self.trace = SpanTracer(capacity=ecfg.trace_capacity)
            host.fm.tracer = self.trace
        overlap = None
        if ecfg.kv_prefetch and ecfg.kv_prefetch_depth:
            # admission gate for prefetch bursts: sized to the decode
            # round's compute window (EWMA-learned from measured rounds)
            from repro_torch.core.overlap import OverlapScheduler
            from repro_torch.core.tiers import TierKind, tpu_tiers
            # the reference's modelled host-link constants: a model input
            # (token parity depends on them), not the card's figures
            overlap = OverlapScheduler(
                tpu_tiers()[TierKind.HOST_DRAM],
                compute_window_s=ecfg.kv_compute_window_s,
                trace=self.trace)
        self.kv = PagedKVStore(
            cfg=model.cfg, host=host, device_id=device_id,
            page_tokens=ecfg.page_tokens, onboard_pages=ecfg.onboard_pages,
            prefetch_depth=(ecfg.kv_prefetch_depth if ecfg.kv_prefetch
                            else 0),
            overlap=overlap, device=self.device)
        self.waiting: deque[Request] = deque()
        self.active: Dict[int, Request] = {}      # slot -> request
        self.requests: Dict[int, Request] = {}
        self._next_req = 0
        self._slot_free = list(range(ecfg.decode_slots))[::-1]
        self._decode_fn = model.decode_step
        #: paged decode: the batched pool-direct step (retires the dense
        #: slot cache for decode); dense stays for uncovered archs
        self._use_paged = (ecfg.paged_decode
                           and model.supports_paged_decode())
        self._max_pages = -(-ecfg.max_seq_len // ecfg.page_tokens)
        #: prefill and the decode step staged as the reference's jax.jit
        #: stages them: prefill one CUDA graph per prompt length, the paged
        #: step one per batch size, the dense slot step one per slot
        #: (static buffers alone on the CPU); ``staged=False`` runs them
        #: eagerly, for comparison on the card
        self.staged_prefill: Optional[StagedPrefill] = None
        self._prefill_fn = self._prefill_eager
        if staged:
            self.staged_prefill = self._prefill_fn = StagedPrefill(
                model.prefill,
                lambda: model.init_cache(1, ecfg.max_seq_len),
                max_seq_len=ecfg.max_seq_len, device=self.device)
        self.staged: Union[StagedStep, StagedSlots, None] = None
        self._paged_fn = None
        if self._use_paged:
            self._paged_fn = model.decode_step_paged
            if staged:
                self.staged = self._paged_fn = StagedStep(
                    model.decode_step_paged, slots=ecfg.decode_slots,
                    max_pages=self._max_pages,
                    page_shape=self.kv.buf.page_shape,
                    dtype=self.kv.buf.dtype, min_pages=ecfg.onboard_pages,
                    device=self.device)
        elif staged:
            self.staged = self._decode_fn = StagedSlots(
                model.decode_step,
                lambda: model.init_cache(1, ecfg.max_seq_len),
                device=self.device)
        for fn in (self.staged_prefill, self.staged):
            if fn is not None:
                fn.trace = self.trace
        self.paged_rounds = 0

    # -------------------------------------------------------------- intake
    def submit(self, spec: Union[SubmitSpec, np.ndarray],
               max_new_tokens: int = 16, tenant: str = "default") -> int:
        """Enqueue one request described by a :class:`SubmitSpec`.

        The pre-redesign ``submit(prompt, max_new_tokens=..., tenant=...)``
        signature still works as a deprecated shim (the positional
        prompt is wrapped into a spec) so out-of-tree callers keep
        running; in-repo callers all pass specs."""
        if not isinstance(spec, SubmitSpec):
            warnings.warn(
                "ServeEngine.submit(prompt, ...) is deprecated; pass a "
                "SubmitSpec (typed submission surface)",
                DeprecationWarning, stacklevel=2)
            spec = SubmitSpec(prompt=spec, max_new_tokens=max_new_tokens,
                              tenant=tenant)
        rid = self._next_req
        self._next_req += 1
        arrived = (self.clock() if spec.arrival_time_s is None
                   else spec.arrival_time_s)
        req = Request(rid, spec.prompt, spec.max_new_tokens,
                      tenant=spec.tenant, submitted_at=arrived,
                      slo_deadline_s=spec.slo_deadline_s,
                      deadline_s=(None if spec.deadline_s is None
                                  else arrived + spec.deadline_s))
        self.requests[rid] = req
        self.waiting.append(req)
        self._tenant_live[spec.tenant] = (
            self._tenant_live.get(spec.tenant, 0) + 1)
        return rid

    # ----------------------------------------------------------- prefill
    def _prefill_eager(self, params, tokens):
        """``Model.prefill`` of ``tokens`` [1, S] into a fresh cache."""
        cache = self.model.init_cache(1, self.ecfg.max_seq_len)
        return self.model.prefill(
            params, {"tokens": tokens.to(self.device)}, cache)

    def _prefill(self, req: Request) -> None:
        tr = self.trace
        with (tr.span("serve.prefill", op="serve", req=req.req_id,
                      tokens=len(req.prompt)) if tr.enabled else NULL_SPAN):
            self._prefill_request(req)

    def _prefill_request(self, req: Request) -> None:
        # prefill runs at prompt length; the dense cache covers max_seq_len.
        # A staged prefill's cache is the one static cache: its pages are
        # copied into the KV store here, and the whole cache into the
        # request's decode slot when it is seated, before the next prefill
        toks = torch.as_tensor(req.prompt[None], dtype=torch.int32)
        logits, cache = self._prefill_fn(self.params, toks)
        req.seq_id = self.kv.new_seq()
        kv = self._cache_to_pages(cache, len(req.prompt))
        if kv is not None:
            self.kv.append_tokens(req.seq_id, kv)
        else:
            self.kv.seq(req.seq_id).length = len(req.prompt)
        # dense handoff only for the slot-cache path; paged decode reads
        # everything back from the pool, so holding the dense cache per
        # request would defeat the capacity story
        req._cache = None if self._use_paged else cache
        tr = self.trace
        with (tr.span("serve.readback", op="serve", req=req.req_id)
              if tr.enabled else NULL_SPAN):
            nxt = int(torch.argmax(logits[0]))    # the one host sync
        req.out_tokens.append(nxt)
        if req.first_token_at is None:
            req.first_token_at = self.clock()
            req.last_token_at = req.first_token_at
            ttft = req.first_token_at - req.submitted_at
            self.metrics.observe(f"serve.ttft.{req.tenant}", ttft)
            tr = self.trace
            if tr.enabled:
                tr.event("ttft", tenant=req.tenant, op="serve",
                         req=req.req_id, ttft_s=ttft)

    def _cache_to_pages(self, cache, length: int):
        if "k" not in cache:
            return None                           # rwkv: O(1) state
        k = cache["k"][:, 0, :length]             # [L, len, KV, hd]
        v = cache["v"][:, 0, :length]
        return torch.stack([k, v], dim=1)         # [L, 2, len, KV, hd]

    # ------------------------------------------------------------- decode
    def _qos_gate(self, req: Request) -> Decision:
        """SLO admission for one fresh request; resumes bypass the gate
        (a preempted request was already admitted — re-seating it is a
        swap-in, not new load on the link)."""
        if self.qos is None or req.state == "preempted":
            return Decision.ADMIT
        return self.qos.decide(req.tenant)

    def _cancel(self, req: Request, reason: str) -> None:
        """Terminal bookkeeping for a deadline-expired or capacity-starved
        request: its KV sequence is freed mid-flight (LMB pages return to
        the pool), the tenant's SLO record counts the cancellation, and
        the tenant's link demand is released once nothing of theirs is
        left in flight.  Callers remove the request from whichever
        structure held it (waiting deque / active slot)."""
        req.state = "cancelled"
        req.cancel_reason = reason
        req.done_at = self.clock()
        if req.seq_id is not None:
            self.kv.free_seq(req.seq_id)
            req.seq_id = None
        self.cancelled.append(req.req_id)
        self._tenant_live[req.tenant] -= 1
        if self.qos is not None:
            self.qos.record_cancel(req.tenant)
            if self._tenant_live[req.tenant] <= 0:
                self.qos.release(req.tenant)
        tr = self.trace
        if tr.enabled:
            tr.event("cancel", tenant=req.tenant, op="serve",
                     req=req.req_id, reason=reason)

    def _expire_waiting(self) -> None:
        """Drop queued (waiting or preempted-and-requeued) requests whose
        deadline has passed, preserving arrival order for the rest.  A
        preempted request's parked KV is freed here too."""
        if not any(r.deadline_s is not None for r in self.waiting):
            return
        now = self.clock()
        keep: List[Request] = []
        for req in self.waiting:
            if req.deadline_s is not None and now >= req.deadline_s:
                self._cancel(req, "deadline")
            else:
                keep.append(req)
        if len(keep) != len(self.waiting):
            self.waiting = deque(keep)

    def _admit(self) -> None:
        tr = self.trace
        with (tr.span("serve.admit", op="serve", waiting=len(self.waiting))
              if tr.enabled else NULL_SPAN):
            self._admit_waiting()

    def _admit_waiting(self) -> None:
        self._expire_waiting()
        considered = 0
        limit = len(self.waiting)   # each waiter gets one decision per round
        deferred: List[Request] = []   # throttled this round
        while self.waiting and self._slot_free and considered < limit:
            considered += 1
            req = self.waiting.popleft()
            decision = self._qos_gate(req)
            if decision is Decision.SHED:
                req.state = "shed"
                self.shed.append(req.req_id)
                self._tenant_live[req.tenant] -= 1
                continue
            if decision is Decision.THROTTLE:
                # retry a later round — deferred requests return to the
                # FRONT of the queue in arrival order (they arrived before
                # everything still waiting), so a throttled tenant cannot
                # leapfrog, and a permanently-throttled one cannot starve
                # later arrivals: each waiter still gets exactly one
                # decision per round, and the deadline bounds its retries
                deferred.append(req)
                continue
            try:
                if req.state == "preempted":
                    self.kv.schedule_swap_in(req.seq_id)  # LMB -> onboard
                else:
                    self._prefill(req)
            except OutOfMemory:
                # pool too degraded to hold the KV (e.g. expander failed
                # with no spare): cancel instead of crashing the engine
                self._cancel(req, "capacity")
                continue
            # NOTE: nothing is pinned — cold pages may spill to the LMB
            # pool freely.  Paged decode faults each round's working set
            # back in one coalesced burst; the dense fallback decodes
            # from its per-request slot cache.
            slot = self._slot_free.pop()
            if isinstance(self.staged, StagedSlots):
                # the request's cache (prefilled, or taken out at its
                # preemption) into the slot's static cache
                self.staged.seat(slot, req._cache)
                req._cache = None
            req.state = "active"
            self.active[slot] = req
        self.waiting.extendleft(reversed(deferred))

    def preempt(self, slot: int) -> None:
        """Evict a running request: its KV pages demote to the LMB tier
        on pressure (LinkedBuffer eviction does the actual move).  On the
        staged dense slot path the request takes a copy of its slot's
        cache with it, to be seated again on resume."""
        req = self.active.pop(slot)
        if isinstance(self.staged, StagedSlots):
            req._cache = self.staged.take(slot)
        req.state = "preempted"
        self.waiting.appendleft(req)
        self._slot_free.append(slot)

    def _schedule_round_prefetch(self) -> None:
        """Feed the prefetcher this round's exact future, batched into
        ONE schedule call so the pages group into per-(chunk, expander)
        bursts instead of per-sequence dribbles.  Dense path: every
        active sequence's next-decode (tail) page.  Paged path: every
        active sequence's FULL page list — the next round's DecodeView
        reads the whole working set, so all of it is exact future
        knowledge for the prefetcher."""
        pages: List[int] = []
        for req in self.active.values():
            if req.seq_id is None:
                continue
            if self._use_paged:
                pages.extend(self.kv.seq(req.seq_id).pages)
            else:
                pages.extend(self.kv.next_decode_pages(req.seq_id))
        if pages:
            self.kv.schedule_prefetch(pages)

    def step(self) -> int:
        """One engine iteration: admit + one decode step per active req.

        Paged decode (the default) batches every active slot into one
        decode step through the paged-attention kernel.  With
        ``kv_prefetch`` on, each round's next-decode KV pages are
        scheduled ahead as bursts.  ``pipeline=True`` (default) runs
        admission and that prefetch scheduling at the END of the round,
        inside the just-measured compute window's link drain; the
        phased order (admit -> prefetch -> decode, never draining)
        remains as the reference mode.  Token streams are byte-identical
        between the two.  When tracing is on, the round runs under a
        ``serve.round`` span whose children are its phases:
        ``serve.admit`` (each ``serve.prefill``, its ``staged.*`` call,
        its KV pages' spans and ``serve.readback``, the host's wait for
        the first token), ``serve.decode`` (``batch``; on the paged path
        ``pages`` and ``pool``, with ``kv.decode_view``, the step's
        ``staged.*`` call, ``serve.readback`` and ``kv.commit_decode``)
        and, pipelined, ``serve.tail`` (the intake half); the TTFT,
        inter-token and cancel events carry the request's ``req``."""
        impl = (self._step_pipelined if self.ecfg.pipeline
                else self._step_phased)
        tr = self.trace
        if not tr.enabled:
            return impl()
        with tr.span("serve.round", op="serve", active=len(self.active),
                     waiting=len(self.waiting),
                     mode=("pipelined" if self.ecfg.pipeline
                           else "phased")):
            return impl()

    def _step_phased(self) -> int:
        """Strictly-phased reference order: admit, schedule this round's
        prefetch, then decode.  Bursts issue at the same modeled instant
        the decode they feed begins, and links never drain between
        rounds — the pre-pipeline behavior, kept for A/B runs."""
        self._admit()
        if self.ecfg.kv_prefetch:
            self._schedule_round_prefetch()
        finished, round_dt = self._decode_round()
        if self.ecfg.kv_prefetch and self.active:
            self.kv.note_compute_window(
                round_dt, observed=self.ecfg.round_time_s is None)
        return finished

    def _step_pipelined(self) -> int:
        """Pipelined order: decode first, then run the intake work for
        the NEXT round — link drain, admission, prefetch scheduling —
        inside the round's compute window.  Arrivals that landed since
        the previous round's tail are caught up before decoding so no
        request waits an extra round versus the phased order."""
        self._admit()                      # catch-up: post-tail arrivals
        finished, round_dt = self._decode_round()
        tr = self.trace
        with (tr.span("serve.tail", op="serve") if tr.enabled
              else NULL_SPAN):
            self._round_tail(round_dt)
        return finished

    def _round_tail(self, round_dt: float) -> None:
        """The pipelined step's intake half, run while the decode
        round's compute window drains the expander links: let modeled
        time pass on every link (advance_links), open the next overlap
        window at the measured round time, admit arrivals, and schedule
        their (plus the surviving actives') next-decode pages as
        prefetch bursts — which now ride a drained link under a freshly
        opened window instead of queueing behind the round's demand
        traffic."""
        if round_dt > 0.0:
            self._fm.advance_links(round_dt)
        if not self.ecfg.kv_prefetch:
            self._admit()
            return
        self.kv.note_compute_window(
            round_dt, observed=self.ecfg.round_time_s is None)
        self._admit()
        self._schedule_round_prefetch()

    def _decode_round(self) -> tuple:
        """One decode pass over the active slots; returns ``(finished,
        round_dt)`` where ``round_dt`` is the round's compute-window
        duration — ``EngineConfig.round_time_s`` when pinned (virtual
        sweeps), measured wall time otherwise.  Dispatches to the paged
        pool-direct round when :attr:`EngineConfig.paged_decode` covers
        the model; the per-request dense-slot loop below is the
        fallback."""
        if self._use_paged:
            return self._decode_round_paged()
        tr = self.trace
        with (tr.span("serve.decode", op="serve", batch=len(self.active))
              if tr.enabled else NULL_SPAN):
            return self._decode_round_dense()

    def _decode_round_dense(self) -> tuple:
        """The per-request dense-slot round (:meth:`_decode_round`)."""
        round_t0 = time.monotonic()
        finished = 0
        for slot, req in list(self.active.items()):
            if (req.deadline_s is not None
                    and self.clock() >= req.deadline_s):
                # mid-flight cancellation: pull the request out of its
                # decode slot and free its KV sequence immediately
                self._cancel(req, "deadline")
                del self.active[slot]
                self._slot_free.append(slot)
                continue
            tok = torch.tensor([[req.out_tokens[-1]]], dtype=torch.int32,
                               device=self.device)
            if self.staged is not None:
                logits, cache = self._decode_fn(self.params, slot, tok)
            else:
                logits, req._cache = self._decode_fn(self.params,
                                                     req._cache, tok)
                cache = req._cache
            tr = self.trace
            with (tr.span("serve.readback", op="serve", req=req.req_id)
                  if tr.enabled else NULL_SPAN):
                nxt = int(torch.argmax(logits[0]))
            req.out_tokens.append(nxt)
            now = self.clock()
            if req.last_token_at is not None:
                gap = now - req.last_token_at
                self.metrics.observe(f"serve.itl.{req.tenant}", gap)
                tr = self.trace
                if tr.enabled:
                    tr.event("token", tenant=req.tenant, op="serve",
                             req=req.req_id, gap_s=gap)
            req.last_token_at = now
            kv_new = self._decode_kv_tail(
                cache, self.kv.seq(req.seq_id).length)
            try:
                if kv_new is not None:
                    self.kv.append_tokens(req.seq_id, kv_new)
                else:
                    self.kv.seq(req.seq_id).length += 1
            except OutOfMemory:
                # the pool shrank under us (failover mid-decode): free
                # what the sequence still holds and release the slot
                self._cancel(req, "capacity")
                del self.active[slot]
                self._slot_free.append(slot)
                continue
            if len(req.out_tokens) >= req.max_new_tokens:
                self._finish_active(slot, req)
                finished += 1
        if self.ecfg.round_time_s is not None:
            return finished, (self.ecfg.round_time_s if self.active
                              or finished else 0.0)
        return finished, time.monotonic() - round_t0

    def _finish_active(self, slot: int, req: Request) -> None:
        """Terminal bookkeeping for a request completing in its slot."""
        req.state = "done"
        req.done_at = self.clock()
        self.kv.free_seq(req.seq_id)
        del self.active[slot]
        self._slot_free.append(slot)
        self._qos_finish(req)

    def _decode_round_paged(self) -> tuple:
        """The pool-direct decode round: ONE batched paged-attention
        step over every active slot, straight against the paged KV pool.

        The round builds a :class:`~repro_torch.serve.kv_cache.DecodeView`
        (tail pages guaranteed, the actives' page union faulted onboard
        with one coalesced burst — the round's touched-page list riding
        the same meter/prefetch accounting as every other access), runs
        the compiled ``decode_step_paged`` once for the whole batch, and
        commits only the tail pages back.  Token streams are
        byte-identical to the dense per-request loop; what changed is
        the data path — no per-request dense cache, no host-side
        gather_seq swap-in.
        """
        round_t0 = time.monotonic()
        finished = 0
        live: List[tuple] = []
        for slot, req in list(self.active.items()):
            if (req.deadline_s is not None
                    and self.clock() >= req.deadline_s):
                # mid-flight cancellation: pull the request out of its
                # decode slot and free its KV sequence immediately
                self._cancel(req, "deadline")
                del self.active[slot]
                self._slot_free.append(slot)
                continue
            if self.kv.seq(req.seq_id).length >= self.ecfg.max_seq_len:
                # context window exhausted: the dense slot cache would
                # silently ring-wrap here; the paged path finishes the
                # request instead of outgrowing its page table
                self._finish_active(slot, req)
                finished += 1
                continue
            live.append((slot, req))
        if live:
            tr = self.trace
            with (tr.span("serve.decode", op="serve", batch=len(live))
                  if tr.enabled else NULL_SPAN) as sid:
                view, nxt_tokens = self._paged_batch(live)
            if view is None:
                live = []
            else:
                self.paged_rounds += 1
                span = tr.closed(sid) if tr.enabled else None
                if span is not None:
                    span.args.update(pages=len(view.pages),
                                     pool=int(view.pool.shape[0]))
        for i, (slot, req) in enumerate(live):
            req.out_tokens.append(nxt_tokens[i])
            now = self.clock()
            if req.last_token_at is not None:
                gap = now - req.last_token_at
                self.metrics.observe(f"serve.itl.{req.tenant}", gap)
                tr = self.trace
                if tr.enabled:
                    tr.event("token", tenant=req.tenant, op="serve",
                             req=req.req_id, gap_s=gap)
            req.last_token_at = now
            if len(req.out_tokens) >= req.max_new_tokens:
                self._finish_active(slot, req)
                finished += 1
        if self.ecfg.round_time_s is not None:
            return finished, (self.ecfg.round_time_s if self.active
                              or finished else 0.0)
        return finished, time.monotonic() - round_t0

    def _paged_batch(self, live: List[tuple]) -> tuple:
        """One batched paged step over ``live`` (slot, request) pairs:
        ``(view, next tokens)``, or ``(None, None)`` when the pool can no
        longer hold the round's pages and the batch was cancelled."""
        try:
            view = self.kv.decode_view(
                [r.seq_id for _, r in live], self._max_pages,
                into=self.staged.rows if self.staged else None)
            toks = torch.tensor([[r.out_tokens[-1]] for _, r in live],
                                dtype=torch.int32, device=self.device)
            logits, pool = self._paged_fn(
                self.params, view.pool,
                torch.as_tensor(view.tables, device=self.device),
                torch.as_tensor(view.lengths, device=self.device), toks)
            # greedy argmax on the device; one host sync per round
            tr = self.trace
            with (tr.span("serve.readback", op="serve", batch=len(live))
                  if tr.enabled else NULL_SPAN):
                nxt_tokens = torch.argmax(logits, dim=-1).tolist()
            self.kv.commit_decode(view, pool)
        except OutOfMemory:
            # the pool shrank under us (failover mid-decode): the
            # round's working set can no longer be materialized —
            # cancel the batch instead of crashing the engine
            for slot, req in live:
                self._cancel(req, "capacity")
                del self.active[slot]
                self._slot_free.append(slot)
            return None, None
        return view, nxt_tokens

    def _qos_finish(self, req: Request) -> None:
        """Feed the completed request's latency to its tenant's SLO
        tracker; drop the tenant's demand off the link once it drains."""
        self._tenant_live[req.tenant] -= 1
        if self.qos is None:
            return
        self.qos.observe(req.tenant, req.done_at - req.submitted_at)
        if self._tenant_live[req.tenant] <= 0:
            self.qos.release(req.tenant)

    def _decode_kv_tail(self, cache, position: int):
        """The K/V the decode step just wrote for the token at
        ``position`` (the sequence's stored length, kept on the host),
        from its ring slot: [L, 2, 1, KV, hd]."""
        if "k" not in cache:
            return None
        C = cache["k"].shape[2]
        slot = position % C
        k = cache["k"][:, 0, slot:slot + 1]
        v = cache["v"][:, 0, slot:slot + 1]
        return torch.stack([k, v], dim=1)

    def run(self, max_iters: int = 1000) -> None:
        it = 0
        while (self.waiting or self.active) and it < max_iters:
            self.step()
            it += 1

    # ------------------------------------------------------------- metrics
    def stats(self) -> dict:
        done = [r for r in self.requests.values() if r.state == "done"]
        ttft = [r.first_token_at - r.submitted_at for r in done
                if r.first_token_at]
        fm = self.kv.buf.host.fm
        # per-tenant latency distributions from the unified registry:
        # serve.ttft.<tenant> / serve.itl.<tenant> histograms with
        # p50/p90/p99 — the numbers the serve-sweep reports against
        hists = self.metrics.snapshot()["histograms"]
        latency = {name: snap for name, snap in sorted(hists.items())
                   if name.startswith("serve.")}
        self.metrics.gauge("fm.journal_len",
                           fm.journal_stats()["len"])
        return {
            "done": len(done),
            "waiting": len(self.waiting),
            "active": len(self.active),
            "decode_path": "paged" if self._use_paged else "dense",
            "paged_rounds": self.paged_rounds,
            "shed": len(self.shed),
            "cancelled": len(self.cancelled),
            "mean_ttft_s": float(np.mean(ttft)) if ttft else None,
            "latency": latency,
            "trace": self.trace.snapshot(),
            "kv": self.kv.stats(),
            "qos": self.qos.snapshot() if self.qos else None,
            # pooled-fabric placement: which expander backs the engine's KV
            # blocks/pages and how loaded each expander's link runs — the
            # signals the MigrationEngine acts on
            "fabric": {
                "block_placement": fm.placement(),
                "kv_page_placement": self.kv.buf.lmb_placement(),
                "link_utilization": fm.link_utilizations(),
                # arbitration round-trips: grows with coalesced bursts,
                # not pages — the batched-data-path health signal
                "meter_calls": fm.meter_calls(),
            },
        }
