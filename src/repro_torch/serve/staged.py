"""The engine's decode steps staged once and replayed as CUDA graphs.

Counterpart of ``repro/serve/engine.py:204-211``, where the reference
stages each engine step with ``jax.jit`` (``_decode_fn =
jax.jit(model.decode_step)``, ``_paged_fn =
jax.jit(model.decode_step_paged)``) and then dispatches the whole step as
one program every round.  Eager PyTorch issues every op of every layer
from Python instead; here each step is captured as a CUDA graph and
replayed.  A graph holds the port's own kernels and PyTorch's ops as the
eager step issues them: it is neither ``torch.compile`` nor a library
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

Both count steps the same way.  A batch size's (a slot's) first step
runs eagerly on the static buffers, so a shape seen once costs what the
eager step costs (and that step is the warm-up capture needs).  The
second captures the step, with nothing run, and replays the graph for
that step's result: the step's in-place writes happen once.  Every later
step replays.  All graphs of a staged step share one memory pool
(``torch.cuda.graph_pool_handle``): they never run at once, and each
step's logits are read before the next replay.  A capture that fails
raises: there is no eager fallback on the card.  The graphs read the
params at the addresses they were captured with, so params are updated
in place; a call with other tensors raises.  Kernel launches and
dispatcher calls are counted by Python code (``cuda_build.LAUNCHES``,
``ops.dispatch_counts``), which a capture runs once and a replay not at
all: each graph records the counts its capture made, takes them back
out, and adds them on every replay, so the counts stay those of the
kernels that ran.

On the CPU (the caller asked for it, as the tests do) the same
static-buffer paths run with the step called directly; no graph exists.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels import ops as kops


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    logits: torch.Tensor            # the graph's static output
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


class _Staged:
    """What both staged steps share: the side stream and the memory pool
    their captures use, the params address check, and capture and replay
    with the counts a graph carries."""

    def __init__(self, step: Callable, device):
        self.step = step
        self.device = torch.device(device)
        self.replays = 0
        #: graphs captured
        self.captures = 0
        #: host seconds spent capturing (graph instantiation included)
        self.capture_s = 0.0
        self._addresses: Optional[Tuple[int, ...]] = None
        self._mempool = self._stream = None
        if self.device.type == "cuda":
            self._mempool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

    def _check_params(self, params) -> None:
        addresses = _addresses(params)
        if self._addresses is None:
            self._addresses = addresses
        elif addresses != self._addresses:
            raise ValueError("the captured graphs read the params at the "
                             "addresses they were captured with: update "
                             "params in place")

    def _replay(self, staged: _Graph) -> torch.Tensor:
        staged.graph.replay()
        cuda_build.add_launches(staged.launches)
        kops.add_dispatches(staged.dispatches)
        self.replays += 1
        return staged.logits

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
                logits, _ = self.step(*args)
            finally:
                graph.capture_end()
        current.wait_stream(self._stream)
        staged = _Graph(graph, logits,
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
                staged = self.graphs[B] = self._capture(args)
            if staged is not None:
                return self._replay(staged), self.pool
        self.eager_rounds += 1
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
                state.graph = self._capture(args)
            if state.graph is not None:
                return self._replay(state.graph), state.cache
        self.eager_steps += 1
        return self.step(*args)
