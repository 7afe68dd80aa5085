"""The engine's prefill and decode steps staged once and replayed as CUDA
graphs.

Counterpart of ``repro/serve/engine.py:204-211``, where the reference
stages each engine function with ``jax.jit`` (``_prefill_fn =
jax.jit(model.prefill)``, ``_decode_fn = jax.jit(model.decode_step)``,
``_paged_fn = jax.jit(model.decode_step_paged)``) and then dispatches the
whole function as one program each call.  Eager PyTorch issues every op
of every layer from Python instead; here each is captured as a CUDA graph
and replayed.  A graph holds the port's own kernels and PyTorch's ops as
the eager call issues them: it is neither ``torch.compile`` nor a library
kernel.

:class:`StagedStep` stages the paged step (``Model.decode_step_paged``),
one graph per exact batch size B the rule captures and per pool the step
reads.
A graph reads fixed addresses, so it keeps its inputs in static buffers
on the device, written before the replay on the stream that replays:

* ``token [slots, 1]``, ``lengths [slots]`` and ``page_table [slots,
  max_pages]`` int32, of which a round of B rows uses rows ``0..B-1``;
* the pool the round brings.  When the round's pages fit the onboard
  tier in one wave, ``PagedKVStore.decode_view`` hands over the tier's
  own onboard pool, which lives at one address for the buffer's life:
  the page table holds onboard slots, and the step writes the new
  token's K/V into the tail pages' slots in place, so no page is copied
  before or after the step.  A round whose pages spill is gathered into
  a pool buffer of this class's own (rows ``0..n-1``,
  :meth:`StagedStep.rows`), made at the first such round at the onboard
  tier's page count and doubled when a round's union outgrows it, up to
  ``slots * max_pages``; its page table maps no row at or past ``n``.

A graph is kept per (pool address, pool rows, B): it is valid for any
pool at that address and shape.  The buffer's regrowth, or a pool from
outside that comes at a new address, drops the graphs that read the old
one, and each B is captured again against the new one as the rule says
(a B the rule bought, at its next call).

The batch is never padded: ``moe_apply`` sizes expert capacity from the
token count and ranks claims by position, so padded rows would take
capacity and change an MoE model's drops.  Where ``jax.jit`` keeps one
executable per input shape (B, and the pool's rows ``n``), a fixed pool
leaves one graph per B.

:class:`StagedSlots` stages the dense-slot step (``Model.decode_step``),
which the reference runs for each request alone at B = 1, so it keeps one
graph per decode slot: each slot owns a static cache
(``model.init_cache(1, max_seq_len)``, made when the slot is first used)
and a static token ``[1, 1]``.  A request's prefilled cache is copied
into its slot's cache when it is seated (:meth:`StagedSlots.seat`) and
copied out when it is preempted; the cache's ``step`` is a device
tensor that the step advances in place, so a replay writes the new
token's K/V at the right slot of the ring and the next replay moves on.

:class:`StagedPrefill` stages ``Model.prefill``, which the reference
runs at the prompt's exact length (it pads the tokens to a bucket, then
passes ``toks[:, :len(prompt)]``), so ``jax.jit`` keeps one executable per
length and this keeps at most one graph per length S (at long,
device-bound lengths an eager call loses little against a replay, so a
length is captured only after many calls).  Its static input is a
token buffer ``[1, max_seq_len]`` int32, of which a prefill at S reads
``[:, :S]``; its static output is **one** prefill cache
(``model.init_cache(1, max_seq_len)``) for every length, which the
prefill resets and fills in place (``trunk_prefill``), so no graph keeps
a cache of its own.  The engine copies what it needs out of that cache
before the next prefill: its pages into the KV store, or its whole cache
into a decode slot's (:meth:`StagedSlots.seat`).

All staged functions follow one rule (:meth:`_Staged._run`), keyed by
the batch size, the slot, the prompt length (or, for the train step,
nothing).  A key's first call runs eagerly on the static buffers, so a
shape seen once costs what the eager call costs (and that call is the
warm-up capture needs).  A key called again is captured when
:class:`CaptureRule` says a graph has paid for itself (ski rental: run
eagerly until the time the key's eager calls lost against a replay
reaches what a capture costs), except the function's first capture,
which comes at the second call of the first key called twice, so that
what a capture costs gets measured.  A capture runs nothing: the graph
is replayed for that call's result, so its in-place writes happen once.
Every later call of the key replays.  Each eager call and each replay
is timed on the device by a pair of CUDA events, read at a later call
once the device has passed them (the engine syncs on every call's
result), so timing adds no sync.  All graphs of a staged function share
one memory pool (``torch.cuda.graph_pool_handle``): they never run at
once, and each call's logits are read before the next replay.  A capture
that fails raises: there is no eager fallback on the card.  The graphs read the
params at the addresses they were captured with, so params are updated
in place; a call with other tensors raises.  Kernel launches and
dispatcher calls are counted by Python code (``cuda_build.LAUNCHES``,
``ops.dispatch_counts``), which a capture runs once and a replay not at
all: each graph records the counts its capture made, takes them back
out, and adds them on every replay, so the counts stay those of the
kernels that ran.

On the CPU (the caller asked for it, as the tests do) the same
static-buffer paths run with the step called directly; no graph exists.

With tracing on (``trace``, the engine's tracer), each call runs under one
span of its mode, ``staged.eager``, ``staged.capture`` or
``staged.replay``, carrying ``fn`` (``prefill``, ``step``, ``slot`` or
``train``) and ``key`` (the prompt length S, the batch size B or the
slot), and ``staged.eager`` ``repeat``, whether the key was called before
(a capture the rule declined); the replay that gives a capture's result
is a ``staged.replay`` span inside its ``staged.capture``, so each mode's
spans count what its counter counts (``eager_calls``, ``captures``,
``replays``; ``eager_repeats`` the eager spans with ``repeat``).  A pool-buffer
regrowth, or a pool from outside at a new address, is a
``staged.regrow`` event with the old and new row counts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels import ops as kops
from repro_torch.obs.trace import GLOBAL_TRACER, NULL_SPAN, SpanTracer


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    output: object                  # the graph's static output
    launches: Dict[str, int]        # kernel launches of one replay
    dispatches: Dict[str, int]      # dispatcher calls of one replay


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def _negate(counts: Dict[str, int]) -> Dict[str, int]:
    return {k: -n for k, n in counts.items()}


def _addresses(tree) -> Tuple[int, ...]:
    """The data addresses of a params tree's tensors, in tree order."""
    if isinstance(tree, dict):
        return sum((_addresses(v) for v in tree.values()), ())
    if isinstance(tree, (list, tuple)):
        return sum((_addresses(v) for v in tree), ())
    return (tree.data_ptr(),) if isinstance(tree, torch.Tensor) else ()


#: the side stream every staged function of a device captures on.
#: PyTorch keeps a cuBLAS workspace for each (thread, stream) that ran a
#: GEMM until the process ends, so a fresh stream per staged function
#: would leave workspaces behind with every engine or training run
_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def side_stream(device) -> "torch.cuda.Stream":
    """``device``'s side stream (made at the first call)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


class CaptureRule:
    """When a staged function captures a key: ski rental.  Each call of a
    key without a graph either rents (runs eagerly) or buys (captures);
    a key is bought once the time its eager calls lost against a replay
    reaches what a capture costs.  Every quantity is the function's own
    measurement, fed in by :meth:`timed` and :meth:`bought`:

    * a capture's cost: the host seconds of the function's captures, each
      with the replay that gives its result (the first launch of a graph
      uploads it), over their number;
    * what an eager call of a key lost: its time less a replay's, where a
      replay of the key has been timed; else its time times the share a
      replay saves on the keys timed both ways (their mean replays summed
      over their mean eager calls summed), and nothing while no key has
      been timed both ways.

    The function's first capture needs neither: it comes at the second
    call of the first key called twice, and measures the cost.  A key
    whose graph was dropped (its pool moved) has lost what it lost
    before, so a key bought by the rule is bought again at its next call.
    """

    def __init__(self):
        #: host seconds of the captures bought, and their number
        self.cost_s = 0.0
        self.captures = 0
        #: [seconds, calls] timed by key, of eager calls and of replays
        self._eager: Dict[object, List[float]] = {}
        self._replay: Dict[object, List[float]] = {}

    def timed(self, key, mode: str, seconds: float) -> None:
        """An eager call (``mode`` ``"eager"``) or a replay of ``key``
        took ``seconds`` on the device."""
        timed = self._eager if mode == "eager" else self._replay
        t = timed.setdefault(key, [0.0, 0])
        t[0] += seconds
        t[1] += 1

    def bought(self, seconds: float) -> None:
        """A capture and the replay that gave its result took ``seconds``
        of host time."""
        self.cost_s += seconds
        self.captures += 1

    def lost(self, key) -> Optional[float]:
        """Seconds ``key``'s timed eager calls lost against replays of it,
        or None while no eager call of it or no replay says what."""
        eager = self._eager.get(key)
        if eager is None:
            return None
        own = self._replay.get(key)
        if own is not None:
            return max(0.0, eager[0] - eager[1] * own[0] / own[1])
        both = [k for k in self._replay if k in self._eager]
        if not both:
            return None
        share = (sum(self._replay[k][0] / self._replay[k][1] for k in both)
                 / sum(self._eager[k][0] / self._eager[k][1] for k in both))
        return eager[0] * max(0.0, 1.0 - share)

    def capture(self, key, calls: int) -> bool:
        """Whether the ``calls``-th call of ``key``, which has no graph,
        captures."""
        if calls < 2:
            return False
        if not self.captures:
            return True
        lost = self.lost(key)
        return lost is not None and lost >= self.cost_s / self.captures


class _EventTimer:
    """Times a call on the device by a pair of CUDA events on the current
    stream; a pair is read only once the device has passed its end, so
    reading never waits."""

    def __init__(self, device: torch.device):
        self.device = device

    def start(self) -> "torch.cuda.Event":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def stop(self, start: "torch.cuda.Event") -> tuple:
        return start, self.start()

    @staticmethod
    def seconds(pair: tuple) -> Optional[float]:
        """The pair's seconds, or None while the device has not passed
        its end."""
        start, end = pair
        return start.elapsed_time(end) / 1e3 if end.query() else None


class _Staged:
    """What every staged function shares (the engine's three here, the
    train step in ``repro_torch.train.staged``): the side stream their
    captures use (one per device, :func:`side_stream`), a memory pool per
    function, the params address check, capture and replay with the
    counts a graph carries, and the rule that picks a call's mode
    (:meth:`_run`, :class:`CaptureRule`)."""

    #: what the spans call the staged function (``fn``)
    FN = ""

    def __init__(self, step: Callable, device):
        self.step = step
        self.device = torch.device(device)
        #: the tracer a call's span goes to (the engine sets its own)
        self.trace: SpanTracer = GLOBAL_TRACER
        #: graphs by the key each is kept under
        self.graphs: Dict[object, _Graph] = {}
        #: calls by the key each is counted under (eager, captured or
        #: replayed)
        self.calls: Dict[object, int] = {}
        self.eager_calls = 0
        #: eager calls of a key called before: captures the rule declined
        self.eager_repeats = 0
        self.replays = 0
        #: graphs captured
        self.captures = 0
        #: host seconds spent capturing (graph instantiation included)
        self.capture_s = 0.0
        #: when a key captures, from this function's own timings
        self.rule = CaptureRule()
        #: what times eager calls and replays on the device (none on the
        #: CPU), and the host clock a capture is timed by
        self.timer: Optional[_EventTimer] = None
        self.host_clock: Callable[[], float] = time.monotonic
        #: (key, mode, timer handle) of calls not yet read
        self._timing: List[tuple] = []
        self._addresses: Optional[Tuple[int, ...]] = None
        self._mempool = self._stream = None
        if self.device.type == "cuda":
            self._mempool = torch.cuda.graph_pool_handle()
            self._stream = side_stream(self.device)
            self.timer = _EventTimer(self.device)

    def stats(self) -> dict:
        return {"captures": self.captures, "replays": self.replays,
                "eager_calls": self.eager_calls,
                "eager_repeats": self.eager_repeats,
                "calls": dict(sorted(self.calls.items())),
                "capture_s": self.capture_s}

    def _run(self, key, graph_key, args) -> Tuple[object, str]:
        """``self.step(*args)`` by the rule, counted under ``key``, its
        graph kept under ``graph_key``: ``(output, mode)``, the output as
        a graph keeps it (:meth:`_output`) and the mode ``"eager"``,
        ``"capture"`` or ``"replay"``.  The key's graph replays if there
        is one; else the call captures if :attr:`rule` says so (the
        replay inside gives the output), and runs eagerly if not.  On the
        CPU every call runs eagerly."""
        self._read_timing()
        n = self.calls[key] = self.calls.get(key, 0) + 1
        if self.device.type == "cuda":
            staged = self.graphs.get(graph_key)
            if staged is not None:
                with self._timed(key, "replay"):
                    return self._replay(staged, key), "replay"
            if self.rule.capture(key, n):
                t0 = self.host_clock()
                with self._span("capture", key):
                    staged = self.graphs[graph_key] = self._capture(args)
                    out = self._replay(staged, key)
                self.rule.bought(self.host_clock() - t0)
                return out, "capture"
        self.eager_calls += 1
        self.eager_repeats += n > 1
        with self._span("eager", key, repeat=n > 1), \
                self._timed(key, "eager"):
            return self._output(self._eager(args)), "eager"

    @contextlib.contextmanager
    def _timed(self, key, mode: str):
        """Time the call inside on the device, for :attr:`rule` to read
        at a later call (nothing on the CPU)."""
        if self.timer is None:
            yield
            return
        start = self.timer.start()
        yield
        self._timing.append((key, mode, self.timer.stop(start)))

    def _read_timing(self) -> None:
        """Hand :attr:`rule` the timings of the calls the device has
        finished; keep the rest for a later call."""
        left = []
        for key, mode, handle in self._timing:
            seconds = self.timer.seconds(handle)
            if seconds is None:
                left.append((key, mode, handle))
            else:
                self.rule.timed(key, mode, seconds)
        self._timing = left

    def _eager(self, args):
        """A call run eagerly."""
        return self.step(*args)

    def _check_params(self, params) -> None:
        addresses = _addresses(params)
        if self._addresses is None:
            self._addresses = addresses
        elif addresses != self._addresses:
            raise ValueError("the captured graphs read their inputs at "
                             "the addresses they were captured with: "
                             "update params (and state) in place")

    def pool_bytes(self) -> int:
        """Device bytes held by the graphs' memory pool (0 on the CPU):
        what the captures' intermediates and outputs pin."""
        if self._mempool is None:
            return 0
        pool = tuple(self._mempool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    @staticmethod
    def _output(result):
        """What a graph keeps of its step's result as its static output:
        a serve step's logits (its cache or pool is a static buffer)."""
        return result[0]

    def _span(self, mode: str, key=None, **args):
        """The span a call in ``mode`` runs under, or the no-op with
        tracing off."""
        tr = self.trace
        if not tr.enabled:
            return NULL_SPAN
        return tr.span("staged." + mode, op="serve", fn=self.FN, key=key,
                       **args)

    def _replay(self, staged: _Graph, key=None):
        with self._span("replay", key):
            staged.graph.replay()
        cuda_build.add_launches(staged.launches)
        kops.add_dispatches(staged.dispatches)
        self.replays += 1
        return staged.output

    def _capture(self, args) -> _Graph:
        """Capture ``self.step(*args)`` as a graph on the side stream
        (nothing runs); the capture's counts come back out and become the
        graph's per-replay counts.  Unlike ``torch.cuda.graph``, the
        caches of device and pinned host memory are left as they are: the
        engine's other stages reuse them every round, unless the cache
        holds more than the card has free: a capture cannot free cached
        blocks (no ``cudaFree`` while capturing), so its new memory could
        not come from them, and the cache is emptied first."""
        t0 = time.monotonic()
        free, _ = torch.cuda.mem_get_info(self.device)
        if (torch.cuda.memory_reserved(self.device)
                - torch.cuda.memory_allocated(self.device)) > free:
            torch.cuda.empty_cache()
        launches, dispatches = (cuda_build.launch_counts(),
                                kops.dispatch_counts())
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._mempool)
            try:
                output = self._output(self.step(*args))
            finally:
                graph.capture_end()
        current.wait_stream(self._stream)
        staged = _Graph(graph, output,
                        _delta(cuda_build.launch_counts(), launches),
                        _delta(kops.dispatch_counts(), dispatches))
        cuda_build.add_launches(_negate(staged.launches))
        kops.add_dispatches(_negate(staged.dispatches))
        self.captures += 1
        self.capture_s += time.monotonic() - t0
        return staged


class StagedStep(_Staged):
    """``step`` (``Model.decode_step_paged``) behind static input buffers,
    captured per batch size B and pool by the rule on a CUDA device.
    Called as the step is, ``(params, pool, page_table, lengths, token)
    -> (logits, pool)``, where ``pool`` is the onboard tier's pool (a
    round that fits one wave) or :meth:`rows` of the round's page count
    (a round that spilled); the returned pool is the one the step read
    and wrote in place (for :meth:`rows`, the whole buffer)."""

    FN = "step"

    def __init__(self, step: Callable, *, slots: int, max_pages: int,
                 page_shape: Sequence[int], dtype: torch.dtype,
                 min_pages: int, device):
        super().__init__(step, device)
        self.slots = slots
        self.max_pages = max_pages
        self.page_shape = tuple(page_shape)
        self.dtype = dtype
        self.min_pages = min(max(min_pages, 1), slots * max_pages)
        i32 = dict(dtype=torch.int32, device=self.device)
        self.token = torch.zeros((slots, 1), **i32)
        self.lengths = torch.zeros((slots,), **i32)
        self.page_table = torch.full((slots, max_pages), -1, **i32)
        #: the pool buffer for rounds that spill, made at the first such
        #: round (:meth:`rows`)
        self.pool: Optional[torch.Tensor] = None
        #: (address, rows) of the last pool that came from outside
        self._outside: Optional[Tuple[int, int]] = None
        #: times the graphs' pool moved: the pool buffer made or doubled,
        #: or a pool from outside at a new address
        self.regrowths = 0

    def stats(self) -> dict:
        return {**super().stats(),
                "pool_pages": 0 if self.pool is None else len(self.pool),
                "regrowths": self.regrowths}

    def _moved(self, old: Optional[Tuple[int, int]], rows: int) -> None:
        """A pool the graphs read moved (``old``: its address and rows,
        None if there was none): drop the graphs that read it, and count
        the move."""
        if old is not None:
            self.graphs = {k: g for k, g in self.graphs.items()
                           if k[:2] != old}
            # a graph memory pool whose graphs are all gone cannot take
            # another capture: the next graphs get a pool of their own
            if not self.graphs and self._mempool is not None:
                self._mempool = torch.cuda.graph_pool_handle()
        self.regrowths += 1
        tr = self.trace
        if tr.enabled:
            tr.event("staged.regrow", op="serve", fn=self.FN,
                     rows_from=0 if old is None else old[1], rows_to=rows)

    def rows(self, n: int) -> torch.Tensor:
        """Rows ``0..n-1`` of the pool buffer, for ``decode_view`` to
        gather a spilling round's ``n`` pages into; makes or doubles the
        buffer (dropping the graphs that read the old one) when ``n``
        does not fit."""
        limit = self.slots * self.max_pages
        if n > limit:
            raise ValueError(f"a round of {n} pages, {self.slots} slots of "
                             f"{self.max_pages} pages")
        have = 0 if self.pool is None else len(self.pool)
        if n > have:
            size = max(self.min_pages, have)
            while size < n:
                size *= 2
            old = None if self.pool is None else (self.pool.data_ptr(),
                                                  have)
            self.pool = None
            self.pool = torch.empty((min(size, limit), *self.page_shape),
                                    dtype=self.dtype, device=self.device)
            self._moved(old, len(self.pool))
        return self.pool[:n]

    def _stage(self, pool, page_table, lengths, token) -> tuple:
        """Check the round's pool (the pool buffer's rows or a whole pool
        from outside) and copy the rest of its inputs into the static
        buffers (on the current stream, the one that replays); returns B
        and the pool the step reads."""
        B = token.shape[0]
        if not 0 < B <= self.slots:
            raise ValueError(f"a batch of {B} rows, {self.slots} slots")
        if tuple(pool.shape[1:]) != self.page_shape or \
                pool.dtype != self.dtype or not pool.is_contiguous():
            raise ValueError(f"a pool {tuple(pool.shape)} {pool.dtype}, "
                             f"want contiguous [P, *{self.page_shape}] "
                             f"{self.dtype}")
        if self.pool is not None and pool.data_ptr() == self.pool.data_ptr():
            if len(pool) > len(self.pool):
                raise ValueError("the round's pages must be gathered into "
                                 "StagedStep.rows(n)")
            pool = self.pool
        elif self._outside != (pool.data_ptr(), len(pool)):
            if self._outside is not None:
                self._moved(self._outside, len(pool))
            self._outside = (pool.data_ptr(), len(pool))
        if tuple(page_table.shape) != (B, self.max_pages):
            raise ValueError(f"page_table {tuple(page_table.shape)}, want "
                             f"({B}, {self.max_pages})")
        self.token[:B].copy_(token)
        self.lengths[:B].copy_(lengths)
        self.page_table[:B].copy_(page_table)
        return B, pool

    def __call__(self, params, pool, page_table, lengths, token):
        """Counted by B, its graph kept by (pool address, pool rows, B):
        a B seen before whose pool moved is captured again."""
        self._check_params(params)
        B, pool = self._stage(pool, page_table, lengths, token)
        args = (params, pool, self.page_table[:B], self.lengths[:B],
                self.token[:B])
        return self._run(B, (pool.data_ptr(), len(pool), B), args)[0], pool


@dataclasses.dataclass
class _Slot:
    cache: Dict[str, torch.Tensor]  # the slot's static cache, B = 1
    token: torch.Tensor             # [1, 1] int32


class StagedSlots(_Staged):
    """``step`` (``Model.decode_step``) on one static cache per decode
    slot, captured per slot by the rule on a CUDA device.  A request is
    seated in a slot with :meth:`seat` and stepped with ``(params, slot,
    token) -> (logits, the slot's cache)``; :meth:`take` copies a
    preempted request's cache out.  ``init_cache()`` makes one slot's
    cache."""

    FN = "slot"

    def __init__(self, step: Callable, init_cache: Callable[[], dict], *,
                 device):
        super().__init__(step, device)
        self.init_cache = init_cache
        self.slots: Dict[int, _Slot] = {}

    def stats(self) -> dict:
        return {**super().stats(), "slots": len(self.slots)}

    def seat(self, slot: int, cache: Dict[str, torch.Tensor]) -> None:
        """Copy ``cache`` (a request's, B = 1) into ``slot``'s static
        cache, making the slot's buffers the first time it is used."""
        state = self.slots.get(slot)
        if state is None:
            state = self.slots[slot] = _Slot(
                self.init_cache(),
                torch.zeros((1, 1), dtype=torch.int32, device=self.device))
        if cache.keys() != state.cache.keys():
            raise ValueError(f"a cache of {sorted(cache)}, the slot's "
                             f"holds {sorted(state.cache)}")
        for key, buf in state.cache.items():
            buf.copy_(cache[key])

    def take(self, slot: int) -> Dict[str, torch.Tensor]:
        """A copy of ``slot``'s cache, for a request leaving the slot with
        its state (preemption): the slot's buffers go on to the next."""
        return {k: v.clone() for k, v in self.slots[slot].cache.items()}

    def __call__(self, params, slot: int, token):
        self._check_params(params)
        state = self.slots[slot]
        state.token.copy_(token)
        return self._run(slot, slot,
                         (params, state.cache, state.token))[0], state.cache


class StagedPrefill(_Staged):
    """``step`` (``Model.prefill``) behind a static token buffer and one
    static prefill cache, captured per prompt length S by the rule on a
    CUDA device.  Called as ``(params, tokens [1, S] int32) -> (logits
    [1, V], cache)``, where ``cache`` is the static cache, filled for this
    prompt and valid until the next call.  ``init_cache()`` makes the
    cache (B = 1, ``max_seq_len`` slots)."""

    FN = "prefill"

    def __init__(self, step: Callable, init_cache: Callable[[], dict], *,
                 max_seq_len: int, device):
        super().__init__(step, device)
        self.tokens = torch.zeros((1, max_seq_len), dtype=torch.int32,
                                  device=self.device)
        self.cache = init_cache()

    def __call__(self, params, tokens):
        self._check_params(params)
        S = tokens.shape[-1]
        if tokens.shape != (1, S) or not 0 < S <= self.tokens.shape[1]:
            raise ValueError(f"tokens {tuple(tokens.shape)}, want (1, S) "
                             f"with 0 < S <= {self.tokens.shape[1]}")
        self.tokens[:, :S].copy_(tokens)
        args = (params, {"tokens": self.tokens[:, :S]}, self.cache)
        return self._run(S, S, args)[0], self.cache
