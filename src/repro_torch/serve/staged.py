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
one graph per exact batch size B that recurs.  A graph reads fixed
addresses, so it keeps its inputs in static buffers on the device,
written before the replay on the stream that replays:

* ``token [slots, 1]``, ``lengths [slots]`` and ``page_table [slots,
  max_pages]`` int32, of which a round of B rows uses rows ``0..B-1``;
* one pool buffer, into which ``PagedKVStore.decode_view`` gathers the
  round's ``n`` pages (rows ``0..n-1``, :meth:`StagedStep.rows`) straight
  from the onboard tier: no second copy of the pages.  Its page table
  maps no row at or past ``n``, so the rows past it are never read.  The
  step writes the new token's K/V into the tail pages of this buffer in
  place, and ``PagedKVStore.commit_decode`` reads them from it.  The
  buffer starts at the onboard tier's page count (a round that fits one
  wave of faults has no more pages) and doubles when a round's union
  outgrows it, up to ``slots * max_pages``; the graphs read the old
  buffer, so they go, and each recurring B is captured again.

The batch is never padded: ``moe_apply`` sizes expert capacity from the
token count and ranks claims by position, so padded rows would take
capacity and change an MoE model's drops.  Where ``jax.jit`` keeps one
executable per input shape (B, and the pool's rows ``n``), the buffer
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
length and this keeps one graph per length S.  Its static input is a
token buffer ``[1, max_seq_len]`` int32, of which a prefill at S reads
``[:, :S]``; its static output is **one** prefill cache
(``model.init_cache(1, max_seq_len)``) for every length, which the
prefill resets and fills in place (``trunk_prefill``), so no graph keeps
a cache of its own.  The engine copies what it needs out of that cache
before the next prefill: its pages into the KV store, or its whole cache
into a decode slot's (:meth:`StagedSlots.seat`).

All three count calls the same way.  A batch size's (a slot's, a prompt
length's) first call runs eagerly on the static buffers, so a shape seen
once costs what the eager call costs (and that call is the warm-up
capture needs).  The second captures the call, with nothing run, and
replays the graph for that call's result: its in-place writes happen
once.  Every later call replays.  All graphs of a staged function share
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
slot); the replay that gives a capture's result is a ``staged.replay``
span inside its ``staged.capture``, so each mode's spans count what its
counter counts (``eager_*``, ``captures``, ``replays``).  A pool-buffer
regrowth is a ``staged.regrow`` event with the old and new row counts.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

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


class _Staged:
    """What every staged function shares (the engine's three here, the
    train step in ``repro_torch.train.staged``): the side stream their
    captures use (one per device, :func:`side_stream`), a memory pool per
    function, the params address check, and capture and replay with the
    counts a graph carries."""

    #: what the spans call the staged function (``fn``)
    FN = ""

    def __init__(self, step: Callable, device):
        self.step = step
        self.device = torch.device(device)
        #: the tracer a call's span goes to (the engine sets its own)
        self.trace: SpanTracer = GLOBAL_TRACER
        self.replays = 0
        #: graphs captured
        self.captures = 0
        #: host seconds spent capturing (graph instantiation included)
        self.capture_s = 0.0
        self._addresses: Optional[Tuple[int, ...]] = None
        self._mempool = self._stream = None
        if self.device.type == "cuda":
            self._mempool = torch.cuda.graph_pool_handle()
            self._stream = side_stream(self.device)

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

    def _span(self, mode: str, key=None):
        """The span a call in ``mode`` runs under, or the no-op with
        tracing off."""
        tr = self.trace
        if not tr.enabled:
            return NULL_SPAN
        return tr.span("staged." + mode, op="serve", fn=self.FN, key=key)

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
        engine's other stages reuse them every round."""
        t0 = time.monotonic()
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
    captured once per recurring batch size B on a CUDA device.  Called as
    the step is, ``(params, pool, page_table, lengths, token) -> (logits,
    pool)``, where ``pool`` is :meth:`rows` of the round's page count and
    the returned pool is the whole buffer (rows ``0..n-1`` are the round's
    pages, the tail pages updated in place)."""

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
        #: the pool buffer, made at the first round (:meth:`rows`)
        self.pool: Optional[torch.Tensor] = None
        self.graphs: Dict[int, _Graph] = {}
        #: rounds run at each batch size (eager, captured or replayed)
        self.rounds: Dict[int, int] = {}
        self.eager_rounds = 0
        #: times the pool buffer was made or doubled
        self.regrowths = 0

    def stats(self) -> dict:
        return {"captures": self.captures, "replays": self.replays,
                "eager_rounds": self.eager_rounds,
                "rounds": dict(sorted(self.rounds.items())),
                "pool_pages": 0 if self.pool is None else len(self.pool),
                "regrowths": self.regrowths, "capture_s": self.capture_s}

    def rows(self, n: int) -> torch.Tensor:
        """Rows ``0..n-1`` of the pool buffer, for ``decode_view`` to
        gather a round's ``n`` pages into; makes or doubles the buffer
        (dropping the graphs, which read the old one) when ``n`` does not
        fit."""
        limit = self.slots * self.max_pages
        if n > limit:
            raise ValueError(f"a round of {n} pages, {self.slots} slots of "
                             f"{self.max_pages} pages")
        have = 0 if self.pool is None else len(self.pool)
        if n > have:
            size = max(self.min_pages, have)
            while size < n:
                size *= 2
            # a graph memory pool whose graphs are all gone cannot take
            # another capture: the next graphs get a pool of their own
            self.graphs.clear()
            if self._mempool is not None:
                self._mempool = torch.cuda.graph_pool_handle()
            self.pool = None
            self.pool = torch.empty((min(size, limit), *self.page_shape),
                                    dtype=self.dtype, device=self.device)
            self.regrowths += 1
            tr = self.trace
            if tr.enabled:
                tr.event("staged.regrow", op="serve", fn=self.FN,
                         rows_from=have, rows_to=len(self.pool))
        return self.pool[:n]

    def _stage(self, pool, page_table, lengths, token) -> int:
        """Check that the round's pages are in the pool buffer and copy
        the rest of its inputs into the static buffers (on the current
        stream, the one that replays); returns B."""
        B = token.shape[0]
        if not 0 < B <= self.slots:
            raise ValueError(f"a batch of {B} rows, {self.slots} slots")
        if self.pool is None or pool.data_ptr() != self.pool.data_ptr() \
                or len(pool) > len(self.pool):
            raise ValueError("the round's pages must be gathered into "
                             "StagedStep.rows(n)")
        if tuple(page_table.shape) != (B, self.max_pages):
            raise ValueError(f"page_table {tuple(page_table.shape)}, want "
                             f"({B}, {self.max_pages})")
        self.token[:B].copy_(token)
        self.lengths[:B].copy_(lengths)
        self.page_table[:B].copy_(page_table)
        return B

    def __call__(self, params, pool, page_table, lengths, token):
        self._check_params(params)
        B = self._stage(pool, page_table, lengths, token)
        self.rounds[B] = self.rounds.get(B, 0) + 1
        args = (params, self.pool, self.page_table[:B], self.lengths[:B],
                self.token[:B])
        if self.device.type == "cuda":
            staged = self.graphs.get(B)
            if staged is None and self.rounds[B] > 1:
                with self._span("capture", B):
                    staged = self.graphs[B] = self._capture(args)
                    return self._replay(staged, B), self.pool
            if staged is not None:
                return self._replay(staged, B), self.pool
        self.eager_rounds += 1
        with self._span("eager", B):
            return self.step(*args)


@dataclasses.dataclass
class _Slot:
    cache: Dict[str, torch.Tensor]  # the slot's static cache, B = 1
    token: torch.Tensor             # [1, 1] int32
    steps: int = 0                  # steps run (eager, captured, replayed)
    graph: Optional[_Graph] = None


class StagedSlots(_Staged):
    """``step`` (``Model.decode_step``) on one static cache per decode
    slot, captured once per slot on a CUDA device.  A request is seated
    in a slot with :meth:`seat` and stepped with ``(params, slot, token)
    -> (logits, the slot's cache)``; :meth:`take` copies a preempted
    request's cache out.  ``init_cache()`` makes one slot's cache."""

    FN = "slot"

    def __init__(self, step: Callable, init_cache: Callable[[], dict], *,
                 device):
        super().__init__(step, device)
        self.init_cache = init_cache
        self.slots: Dict[int, _Slot] = {}
        self.eager_steps = 0

    def stats(self) -> dict:
        return {"captures": self.captures, "replays": self.replays,
                "eager_steps": self.eager_steps,
                "steps": {s: st.steps for s, st in sorted(self.slots.items())},
                "slots": len(self.slots), "capture_s": self.capture_s}

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
        state.steps += 1
        args = (params, state.cache, state.token)
        if self.device.type == "cuda":
            if state.graph is None and state.steps > 1:
                with self._span("capture", slot):
                    state.graph = self._capture(args)
                    return self._replay(state.graph, slot), state.cache
            if state.graph is not None:
                return self._replay(state.graph, slot), state.cache
        self.eager_steps += 1
        with self._span("eager", slot):
            return self.step(*args)


class StagedPrefill(_Staged):
    """``step`` (``Model.prefill``) behind a static token buffer and one
    static prefill cache, captured once per recurring prompt length S on
    a CUDA device.  Called as ``(params, tokens [1, S] int32) -> (logits
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
        self.graphs: Dict[int, _Graph] = {}
        #: prefills run at each prompt length (eager, captured, replayed)
        self.prefills: Dict[int, int] = {}
        self.eager_prefills = 0

    def stats(self) -> dict:
        return {"captures": self.captures, "replays": self.replays,
                "eager_prefills": self.eager_prefills,
                "prefills": dict(sorted(self.prefills.items())),
                "capture_s": self.capture_s}

    def __call__(self, params, tokens):
        self._check_params(params)
        S = tokens.shape[-1]
        if tokens.shape != (1, S) or not 0 < S <= self.tokens.shape[1]:
            raise ValueError(f"tokens {tuple(tokens.shape)}, want (1, S) "
                             f"with 0 < S <= {self.tokens.shape[1]}")
        self.tokens[:, :S].copy_(tokens)
        self.prefills[S] = self.prefills.get(S, 0) + 1
        args = (params, {"tokens": self.tokens[:, :S]}, self.cache)
        if self.device.type == "cuda":
            staged = self.graphs.get(S)
            if staged is None and self.prefills[S] > 1:
                with self._span("capture", S):
                    staged = self.graphs[S] = self._capture(args)
                    return self._replay(staged, S), self.cache
            if staged is not None:
                return self._replay(staged, S), self.cache
        self.eager_prefills += 1
        with self._span("eager", S):
            return self.step(*args)
