"""PyTorch execution of LMB tier moves.

The LMB pool's live backing store on a GPU host is **pinned host memory**
behind PCIe — the byte-addressable, larger, slower tier the card's copy
engines reach without a bounce buffer (the paper's P2P/CXL.mem path).
Two tiers, as in ``repro.core.offload``:

  * ``device``      — the card's HBM (the "onboard" tier)
  * ``pinned_host`` — page-locked host DRAM (the "LMB" tier)

Two modes, chosen by the executor's device:

  * **CUDA**: the onboard pool is a device tensor and each LMB chunk pool
    is a pinned host tensor.  A burst moves pages with the card's copy
    engines, as the reference's one DMA descriptor per run does: one
    asynchronous copy per run of consecutive slots, straight between the
    pinned pool and device rows, reads on the device's H2D copy stream and
    writes on its D2H copy stream (:class:`CopyStreams`), ordered by
    events and never waited for on the host (:meth:`TierExecutor.settle`
    waits).
  * **CPU** (modelling mode, what the tests run): both pools are CPU
    tensors and only the accounting tells the tiers apart — the same mode
    the JAX reference takes when its backend reports no host memories.

Unlike JAX arrays, torch tensors are mutable and ``pool[slot]`` is a view:
every read here returns a fresh tensor that does not alias a pool, and
every write updates the pool **in place** and returns it (the JAX
"write returns the pool" contract, kept so ``LinkedBuffer``'s bookkeeping
reads the same).

Whole trees move with :func:`tree_put_tier`, the trainer's host-stage path
for its optimizer state, which waits for its copies.  That is the CPU's
mode, and the reference's wherever XLA cannot compile memory kinds:
functionally what the in-jit mode does, with no overlap.

The in-jit mode is the reference's on its accelerator: the step is
compiled with ``memory_kind`` annotations on its offloaded operands and
results, and XLA schedules the HBM<->host copies beside its compute.
torch has no memory kinds, sharded or not; the staged train step moves
its parked state itself, with explicit copies a CUDA graph holds as its
own nodes.  :func:`page_in` and :func:`page_out` issue them on the
current stream, in series with the step (the serial schedule);
:func:`page_in_streamed` and :func:`page_out_streamed` are the
counterpart of the annotations (:func:`supports_in_jit_offload` is True
on a card): each leaf moves on one of a device's two copy streams
(:class:`CopyStreams`, host-to-device and device-to-host, one copy
engine each) and an event per leaf and direction tells its consumer
when it has landed, so the copies run beside the forward and backward
passes and the update.  On CUDA ``pinned_host`` is page-locked CPU
memory (a :class:`PinnedArena` the trainer fills in place every step);
on the CPU the tensors stay where they are, as in the executor's
modelling mode.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.devices import resolve_device
from repro_torch.obs.trace import GLOBAL_TRACER, SpanTracer

DEVICE = "device"
PINNED_HOST = "pinned_host"


def backend_memory_kinds(device="cuda") -> tuple:
    """The tiers a run on ``device`` can place tensors in."""
    if resolve_device(device).type == "cuda":
        return (DEVICE, PINNED_HOST)
    return (DEVICE,)


def supports_in_jit_offload(device="cuda") -> bool:
    """Whether a staged step on ``device`` can keep state in host memory
    and move it beside its compute, as XLA's memory kinds do: on a card,
    yes (:func:`page_in_streamed`, :func:`page_out_streamed` on its
    :class:`CopyStreams`, inside the step's CUDA graph); on the CPU, or
    where there is no card, no."""
    return torch.device(device).type == "cuda" and torch.cuda.is_available()


def tier_of(x: torch.Tensor) -> str:
    """``pinned_host`` for page-locked host memory, else ``device`` (the
    card's memory, or any tensor of a CPU run: modelling mode)."""
    return PINNED_HOST if x.device.type == "cpu" and x.is_pinned() \
        else DEVICE


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def put_tier(x: torch.Tensor, memory_kind: str,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Move one tensor to a tier; the copy is issued on the current stream
    and not waited for (:func:`tree_put_tier` waits).

    To ``device``, a pinned host tensor goes to the card and anything else
    stays.  To ``pinned_host``, a card tensor is copied into ``out`` (a
    page-locked tensor of its shape and dtype, reused step after step) or
    into new page-locked memory; a tensor that is not on a card has no
    pinned tier to go to, and asking for one raises rather than leave the
    tensor where it is."""
    if memory_kind == DEVICE:
        if tier_of(x) != PINNED_HOST:
            return x
        return x.to("cuda", non_blocking=True)
    if memory_kind != PINNED_HOST:
        raise ValueError(f"unknown memory kind {memory_kind!r}")
    if tier_of(x) == PINNED_HOST:
        return x
    if not x.is_cuda:
        raise RuntimeError(
            f"no pinned host tier for a {x.device} tensor: pinned memory is "
            "the host side of a card's PCIe link (a CPU run keeps its state "
            "in the device tier)")
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    elif (out.shape != x.shape or out.dtype != x.dtype
          or tier_of(out) != PINNED_HOST):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} "
                         f"({tier_of(out)}) cannot take {tuple(x.shape)} "
                         f"{x.dtype}")
    out.copy_(x, non_blocking=True)
    return out


def _put_tree(tree: Any, memory_kind: str, out: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _put_tree(v, memory_kind, None if out is None else out[k])
                for k, v in tree.items()}
    return put_tier(tree, memory_kind, out)


def tree_put_tier(tree: Any, memory_kind: str, out: Any = None) -> Any:
    """:func:`put_tier` over a dict tree (``out``, when given, a tree of
    the same structure); returns once every copy has landed, so the host
    copies may be read and the device ones used at once."""
    res = _put_tree(tree, memory_kind, out)
    if any(a is not b for (_, a), (_, b) in zip(_paths(tree), _paths(res))):
        torch.cuda.synchronize()
    return res


def page_in(parked: Any) -> Any:
    """The tree on the card: each pinned host leaf copied to new device
    memory, every other leaf as it is.  The copies are issued on the
    current stream and not waited for (no host sync: a CUDA graph can
    hold them)."""
    return _put_tree(parked, DEVICE, None)


def page_out(live: Any, parked: Any) -> None:
    """Copy each leaf of ``live`` that :func:`page_in` moved back into its
    ``parked`` tensor; a leaf that was not moved is ``parked``'s own and
    stays.  Issued on the current stream and not waited for: read the
    parked tensors on the host only after the stream is synchronized."""
    for (_, p), (_, x) in zip(_paths(parked), _paths(live)):
        put_tier(x, tier_of(p), out=p)


class CopyStreams:
    """A card's two copy streams, ``h2d`` (host to device) and ``d2h``
    (device to host), and the stream operations the streamed page moves
    make on them: :meth:`record` an event, :meth:`wait` for one, run on a
    stream (:meth:`on`), :meth:`copy_`.  Every call goes through this
    object, so a stand-in that records them (the tests) sees the whole
    schedule.  Made once per device (:func:`copy_streams`); a stream that
    cannot be made raises."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.h2d = torch.cuda.Stream(self.device)
        self.d2h = torch.cuda.Stream(self.device)

    def current(self):
        """The stream the step computes on (the capture stream)."""
        return torch.cuda.current_stream(self.device)

    def on(self, stream):
        return torch.cuda.stream(stream)

    def record(self, stream):
        event = torch.cuda.Event()
        event.record(stream)
        return event

    def wait(self, stream, event) -> None:
        stream.wait_event(event)

    def copy_(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        dst.copy_(src, non_blocking=True)

    def moves(self, leaf: torch.Tensor) -> bool:
        """Whether a parked leaf is paged (it is in pinned host memory)."""
        return tier_of(leaf) == PINNED_HOST

    def keep(self, tensor: torch.Tensor, stream) -> None:
        """``tensor``'s memory is not handed out again before the work
        issued on ``stream`` so far is done (a copy there still reads
        it, after the compute stream may have dropped it)."""
        tensor.record_stream(stream)

    def synchronize(self, event) -> None:
        """The host waits for ``event``."""
        event.synchronize()

    def fork(self, stream) -> None:
        """``stream`` waits for what the current stream has issued."""
        self.wait(stream, self.record(self.current()))

    def join(self) -> None:
        """The current stream waits for both copy streams: a capture ends
        joined, and the next step's page-in reads no parked tensor a
        page-out is still writing."""
        current = self.current()
        for stream in (self.h2d, self.d2h):
            self.wait(current, self.record(stream))


class HostStreams(CopyStreams):
    """The CPU's stand-in: one host thread, so every "stream" is a name,
    an event is nothing to wait for and a copy has landed when it
    returns.  Nothing is paged on the CPU (modelling mode)."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.h2d, self.d2h = "h2d", "d2h"

    def current(self):
        return "compute"

    def on(self, stream):
        return contextlib.nullcontext()

    def record(self, stream):
        return None

    def wait(self, stream, event) -> None:
        pass

    def copy_(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        dst.copy_(src)

    def keep(self, tensor: torch.Tensor, stream) -> None:
        pass

    def synchronize(self, event) -> None:
        pass


#: each card's copy streams, shared by every streamed step on it
_COPY_STREAMS: Dict[torch.device, CopyStreams] = {}


def copy_streams(device) -> CopyStreams:
    """``device``'s :class:`CopyStreams` (made at the first call), or a
    :class:`HostStreams` for the CPU."""
    device = resolve_device(device)
    if device.type != "cuda":
        return HostStreams(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _COPY_STREAMS:
        _COPY_STREAMS[device] = CopyStreams(device)
    return _COPY_STREAMS[device]


def leaf_at(tree: Any, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def page_in_streamed(parked: Any, order: Sequence[tuple],
                     streams: CopyStreams) -> Tuple[Any, Dict[tuple, Any]]:
    """:func:`page_in` leaf by leaf on ``streams.h2d``, in ``order`` (key
    paths, every leaf of ``parked`` once): returns ``(live, arrived)``,
    ``live`` the tree on the card and ``arrived`` the event recorded on
    the H2D stream after each path's copy.  A consumer of a leaf waits on
    its own event, and no more.  Every device copy is allocated here, on
    the current stream, before the H2D stream forks from it, and the
    copies are all issued at once and not waited for; keep ``live`` until
    :meth:`CopyStreams.join`, since the copy streams' use of its tensors
    is not known to the allocator."""
    order = [tuple(p) for p in order]
    paths = [p for p, _ in _paths(parked)]
    if sorted(order, key=repr) != sorted(paths, key=repr):
        raise ValueError(f"page-in order {order} is not the tree's leaves "
                         f"{paths}")

    def alloc(leaf):
        if isinstance(leaf, dict):
            return {k: alloc(v) for k, v in leaf.items()}
        if not streams.moves(leaf):
            return leaf
        return torch.empty(leaf.shape, dtype=leaf.dtype,
                           device=streams.device)

    live = alloc(parked)
    streams.fork(streams.h2d)
    arrived = {}
    with streams.on(streams.h2d):
        for path in order:
            src, dst = leaf_at(parked, path), leaf_at(live, path)
            if dst is not src:
                streams.copy_(dst, src)
            arrived[path] = streams.record(streams.h2d)
    return live, arrived


def page_out_streamed(live: Any, parked: Any, paths: Sequence[tuple],
                      written: Any, streams: CopyStreams) -> None:
    """:func:`page_out` of the leaves at ``paths`` on ``streams.d2h``,
    once ``written`` (an event recorded where they were last written)
    has passed; not waited for."""
    streams.wait(streams.d2h, written)
    with streams.on(streams.d2h):
        for path in paths:
            src, dst = leaf_at(live, path), leaf_at(parked, path)
            if src is not dst:
                streams.copy_(dst, src)


def nbytes_of(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(nbytes_of(v) for v in tree.values())
    return _nbytes(tree)


def _paths(tree: Any, prefix: tuple = ()):
    """(key path, leaf) of a dict tree, in its own order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class PinnedArena:
    """Page-locked host memory for a whole tree, allocated and locked once.

    One host slab holds every leaf back to back (each at a 256-byte
    offset) and is page-locked with ``cudaHostRegister``; :attr:`tree`
    holds the leaves as views, ready to be ``out`` of
    :func:`tree_put_tier`.  One slab of exactly the tree's size, because
    torch's pinned allocator rounds each block up to a power of two (a
    1.54 GB leaf would hold 2 GiB).  If the memory cannot be locked this
    raises: the state never stays quietly on the card.
    :meth:`close` unlocks the slab; its views stay valid host memory."""

    ALIGN = 256

    def __init__(self, template: Any):
        # (path, byte offset, shape, dtype) per leaf: the template's
        # tensors themselves are not kept
        layout, total = [], 0
        for path, t in _paths(template):
            layout.append((path, total, t.shape, t.dtype))
            total += -(-_nbytes(t) // self.ALIGN) * self.ALIGN
        self.nbytes = total
        torch.cuda.init()
        self._slab = torch.empty(max(total, 1), dtype=torch.uint8)
        err = torch.cuda.cudart().cudaHostRegister(
            self._slab.data_ptr(), self._slab.numel(), 0)
        if int(err) != 0:
            self._slab = None
            raise RuntimeError(f"cudaHostRegister of {total} B failed "
                               f"(cudaError {int(err)})")
        self.tree: dict = {}
        for path, off, shape, dtype in layout:
            nb = shape.numel() * dtype.itemsize
            node = self.tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = self._slab[off:off + nb].view(dtype).view(shape)

    def close(self) -> None:
        if self._slab is not None:
            torch.cuda.cudart().cudaHostUnregister(self._slab.data_ptr())
            self._slab = None


def _runs(slots: Sequence[int]) -> List[List[int]]:
    """``[position, first slot, length]`` of each maximal run of
    ``slots`` whose entries are consecutive slots; a repeated slot starts
    a run of its own."""
    runs: List[List[int]] = []
    for i, s in enumerate(map(int, slots)):
        if runs and s == runs[-1][1] + runs[-1][2]:
            runs[-1][2] += 1
        else:
            runs.append([i, s, 1])
    return runs


class TierExecutor:
    """Executes LinkedBuffer page moves on torch tensors.

    Pages live in a pool tensor per tier; moves are slice copies.  On CUDA
    the LMB-tier pools are pinned host tensors (real host residency, real
    PCIe transfers): a burst against one is one asynchronous copy per run
    of consecutive slots on the device's copy streams (``streams``, from
    :func:`copy_streams`), so neither the host nor the compute stream
    waits for the link, and every consumer on the compute stream sees the
    pages landed.  On the CPU the LMB tier is a plain CPU tensor and only
    the accounting distinguishes tiers (pure modelling mode — still
    exercises every allocator/policy path); nothing is copied on a
    stream there.
    """

    def __init__(self, device="cuda", *,
                 meter: Optional[Callable[[int], float]] = None,
                 trace: Optional[SpanTracer] = None):
        self.device = resolve_device(device)
        self.lmb_memory_kind = (PINNED_HOST if self.device.type == "cuda"
                                else DEVICE)
        self.real_host_tier = self.lmb_memory_kind != DEVICE
        #: the copy streams LMB bursts run on; ``streams.moves(pool)``
        #: tells which pools they move (the pinned ones)
        self.streams = copy_streams(self.device)
        #: the event after the last read (H2D) and write (D2H) burst
        self._read_done = self._write_done = None
        #: span tracer for coalesced pool transfers (wall-clock spans)
        self.trace = trace if trace is not None else GLOBAL_TRACER
        #: QoS hook charged with nbytes for every page crossing the
        #: host<->device boundary; in modelling mode executor-level moves
        #: are indistinguishable from device ops, so consumers that want
        #: link accounting meter at their own layer (LinkedBuffer)
        self.meter = meter

    def tier_of(self, pool: torch.Tensor) -> str:
        if self.real_host_tier and pool.device.type == "cpu":
            return PINNED_HOST
        return DEVICE

    def _meter(self, pool: torch.Tensor, nbytes: int) -> None:
        if self.meter is not None and self.tier_of(pool) != DEVICE:
            self.meter(nbytes)

    @staticmethod
    def _page_bytes(pool: torch.Tensor) -> int:
        return pool[0].numel() * pool.element_size()

    def alloc_pool(self, npages: int, page_shape: tuple, dtype,
                   tier: str) -> torch.Tensor:
        shape = (npages, *page_shape)
        if tier == "lmb" and self.real_host_tier:
            return torch.zeros(shape, dtype=dtype, pin_memory=True)
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _to_tier(self, pool: torch.Tensor,
                 data: torch.Tensor) -> torch.Tensor:
        """``data`` on the pool's device and dtype, ready to store."""
        return data.to(device=pool.device, dtype=pool.dtype)

    def read_page(self, pool: torch.Tensor, slot: int) -> torch.Tensor:
        self._meter(pool, self._page_bytes(pool))
        return self._read_pages(pool, [slot])[0]

    def write_page(self, pool: torch.Tensor, slot: int,
                   page: torch.Tensor) -> torch.Tensor:
        """In place: ``pool[slot] = page``; returns the pool."""
        self._meter(pool, self._page_bytes(pool))
        return self._write_pages(pool, [slot], page[None])

    def move_page(self, src_pool: torch.Tensor, src_slot: int,
                  dst_pool: torch.Tensor, dst_slot: int) -> torch.Tensor:
        """``dst_pool[dst_slot] = src_pool[src_slot]`` through the device
        (a read, then a write: both tiers' meters charged); returns
        ``dst_pool``."""
        return self.write_page(dst_pool, dst_slot,
                               self.read_page(src_pool, src_slot))

    def settle(self) -> None:
        """Return once every burst issued so far has landed: (f) before a
        pool is dropped, and (g) before host code reads a pinned pool's
        bytes."""
        for event in (self._read_done, self._write_done):
            if event is not None:
                self.streams.synchronize(event)

    # ---- coalesced multi-page transfers (the batched data path) ----
    # One copy per run of consecutive slots instead of N slice copies (on
    # a pinned pool, one DMA per run, as the reference's TPU gather), and
    # the meter hook (when bound) sees ONE charge for the burst's bytes.
    # On a pinned pool the copies are queued on the copy streams and the
    # host does not wait, so the ``exec.read_pages`` / ``exec.write_pages``
    # spans time the issue of a burst, not its transfer; chip_smoke.py's
    # burst breakdown synchronises to time the transfer.

    def read_pages(self, pool: torch.Tensor, slots: Sequence[int],
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Coalesced read: ``[len(slots), *page_shape]`` stacked onboard
        (into ``out`` if given).  Duplicate slots are allowed (a gather
        may repeat pages)."""
        self._meter(pool, self._page_bytes(pool) * len(slots))
        tr = self.trace
        if tr.enabled:
            with tr.span("exec.read_pages", op="demand",
                         nbytes=self._page_bytes(pool) * len(slots),
                         pages=len(slots), tier=self.tier_of(pool)):
                return self._read_pages(pool, slots, out)
        return self._read_pages(pool, slots, out)

    def _read_pages(self, pool: torch.Tensor, slots: Sequence[int],
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
        st = self.streams
        if not st.moves(pool):
            # index_select allocates: the result never aliases the pool
            idx = torch.as_tensor(list(slots), dtype=torch.long,
                                  device=pool.device)
            if out is not None:
                return torch.index_select(pool, 0, idx, out=out)
            return pool.index_select(0, idx)
        if out is None:
            out = torch.empty((len(slots), *pool.shape[1:]),
                              dtype=pool.dtype, device=self.device)
        # (a) the H2D into ``out`` waits for the compute stream's last use
        # of it: a replay reading the staged pool buffer, or whatever the
        # allocator last gave a fresh tensor's memory to
        st.fork(st.h2d)
        # (d) read after write: a page written back in one wave may be
        # read in the next, so the H2D waits for every earlier D2H
        if self._write_done is not None:
            st.wait(st.h2d, self._write_done)
        with st.on(st.h2d):
            for i, s, n in _runs(slots):
                st.copy_(out[i:i + n], pool[s:s + n])
            self._read_done = st.record(st.h2d)
        # (b) the compute stream's use of the pages waits for their H2D;
        # the host does not
        st.wait(st.current(), self._read_done)
        return out

    def write_pages(self, pool: torch.Tensor, slots: Sequence[int],
                    pages: torch.Tensor) -> torch.Tensor:
        """Coalesced in-place write of ``pages[i] -> pool[slots[i]]``;
        returns the pool.  Slots must be distinct.  On a pinned pool the
        copy is read from ``pages`` later, on the D2H stream: do not
        write ``pages`` again (the buffer passes fresh tensors)."""
        tier = self.tier_of(pool)
        self._meter(pool, self._page_bytes(pool) * len(slots))
        tr = self.trace
        if tr.enabled:
            with tr.span("exec.write_pages", op="demand",
                         nbytes=self._page_bytes(pool) * len(slots),
                         pages=len(slots), tier=tier):
                return self._write_pages(pool, slots, pages)
        return self._write_pages(pool, slots, pages)

    def _write_pages(self, pool: torch.Tensor, slots: Sequence[int],
                     pages: torch.Tensor) -> torch.Tensor:
        st = self.streams
        if not st.moves(pool):
            pages = self._to_tier(pool, pages)
            if len(slots) == 1:
                pool[int(slots[0])].copy_(pages[0])
                return pool
            idx = torch.as_tensor(list(slots), dtype=torch.long,
                                  device=pool.device)
            pool.index_copy_(0, idx, pages)
            return pool
        pages = pages.to(device=self.device, dtype=pool.dtype)
        # (c) the D2H waits for the compute stream that produced ``pages``;
        # (e) write after read, a slot read and freed earlier and taken
        # again here, follows: the compute stream waited for every
        # earlier H2D at (b)
        st.fork(st.d2h)
        with st.on(st.d2h):
            for i, s, n in _runs(slots):
                st.copy_(pool[s:s + n], pages[i:i + n])
            self._write_done = st.record(st.d2h)
        # the compute stream may drop ``pages`` before the D2H has read it
        st.keep(pages, st.d2h)
        return pool
