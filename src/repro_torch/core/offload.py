"""PyTorch execution of LMB tier moves.

The LMB pool's live backing store on a GPU host is **pinned host memory**
behind PCIe — the byte-addressable, larger, slower tier the card's copy
engines reach without a bounce buffer (the paper's P2P/CXL.mem path).
Two tiers, as in ``repro.core.offload``:

  * ``device``      — the card's HBM (the "onboard" tier)
  * ``pinned_host`` — page-locked host DRAM (the "LMB" tier)

Two modes, chosen by the executor's device:

  * **CUDA**: the onboard pool is a device tensor and each LMB chunk pool
    is a pinned host tensor.  A read burst is one ``index_select`` into a
    pinned staging tensor plus one ``.to(device, non_blocking=True)``; a
    write burst is one device-to-host copy plus one ``index_copy_``.
  * **CPU** (modelling mode, what the tests run): both pools are CPU
    tensors and only the accounting tells the tiers apart — the same mode
    the JAX reference takes when its backend reports no host memories.

Unlike JAX arrays, torch tensors are mutable and ``pool[slot]`` is a view:
every read here returns a fresh tensor that does not alias a pool, and
every write updates the pool **in place** and returns it (the JAX
"write returns the pool" contract, kept so ``LinkedBuffer``'s bookkeeping
reads the same).

Whole trees move with :func:`tree_put_tier`, the trainer's host-stage path
for its optimizer state.  torch has no memory kinds inside a compiled
step, so :func:`supports_in_jit_offload` is False and the trainer always
pages the state eagerly between steps.  On CUDA ``pinned_host`` is
page-locked CPU memory (a :class:`PinnedArena` the trainer fills in place
every step); on the CPU the tensors stay where they are, as in the
executor's modelling mode.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

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


def supports_in_jit_offload() -> bool:
    """Whether a compiled step can stream state between tiers itself: not
    in torch, so tier moves are always eager (the host-stage path)."""
    return False


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


class TierExecutor:
    """Executes LinkedBuffer page moves on torch tensors.

    Pages live in a pool tensor per tier; moves are slice copies.  On CUDA
    the LMB-tier pools are pinned host tensors (real host residency, real
    PCIe transfers); on the CPU the LMB tier is a plain CPU tensor and only
    the accounting distinguishes tiers (pure modelling mode — still
    exercises every allocator/policy path).
    """

    def __init__(self, device="cuda", *,
                 meter: Optional[Callable[[int], float]] = None,
                 trace: Optional[SpanTracer] = None):
        self.device = resolve_device(device)
        self.lmb_memory_kind = (PINNED_HOST if self.device.type == "cuda"
                                else DEVICE)
        self.real_host_tier = self.lmb_memory_kind != DEVICE
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
        pool[slot].copy_(self._to_tier(pool, page))
        return pool

    # ---- coalesced multi-page transfers (the batched data path) ----
    # One gather/scatter against the pool instead of N slice copies, and
    # the meter hook (when bound) sees ONE charge for the burst's bytes.

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
        idx = torch.as_tensor(list(slots), dtype=torch.long)
        if pool.device.type == "cpu" and self.real_host_tier:
            # gather into pinned staging so the host->device copy is a
            # true async DMA; the caching host allocator keeps the staging
            # block alive until the copy on the current stream is done
            staging = torch.empty((len(slots), *pool.shape[1:]),
                                  dtype=pool.dtype, pin_memory=True)
            torch.index_select(pool, 0, idx, out=staging)
            if out is not None:
                return out.copy_(staging, non_blocking=True)
            return staging.to(self.device, non_blocking=True)
        # index_select allocates: the result never aliases the pool
        idx = idx.to(pool.device)
        if out is not None:
            return torch.index_select(pool, 0, idx, out=out)
        return pool.index_select(0, idx)

    def write_pages(self, pool: torch.Tensor, slots: Sequence[int],
                    pages: torch.Tensor) -> torch.Tensor:
        """Coalesced in-place write of ``pages[i] -> pool[slots[i]]``;
        returns the pool.  Slots must be distinct."""
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
        # a device->host copy into pageable memory is synchronous, so the
        # host-side scatter below never races the transfer
        pages = self._to_tier(pool, pages)
        idx = torch.as_tensor(list(slots), dtype=torch.long,
                              device=pool.device)
        pool.index_copy_(0, idx, pages)
        return pool
