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
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.devices import resolve_device
from repro_torch.obs.trace import GLOBAL_TRACER, SpanTracer

DEVICE = "device"
PINNED_HOST = "pinned_host"


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

    def read_pages(self, pool: torch.Tensor,
                   slots: Sequence[int]) -> torch.Tensor:
        """Coalesced read: ``[len(slots), *page_shape]`` stacked onboard.
        Duplicate slots are allowed (a gather may repeat pages)."""
        self._meter(pool, self._page_bytes(pool) * len(slots))
        tr = self.trace
        if tr.enabled:
            with tr.span("exec.read_pages", op="demand",
                         nbytes=self._page_bytes(pool) * len(slots),
                         pages=len(slots), tier=self.tier_of(pool)):
                return self._read_pages(pool, slots)
        return self._read_pages(pool, slots)

    def _read_pages(self, pool: torch.Tensor,
                    slots: Sequence[int]) -> torch.Tensor:
        idx = torch.as_tensor(list(slots), dtype=torch.long)
        if pool.device.type == "cpu" and self.real_host_tier:
            # gather into pinned staging so the host->device copy is a
            # true async DMA; the caching host allocator keeps the staging
            # block alive until the copy on the current stream is done
            staging = torch.empty((len(slots), *pool.shape[1:]),
                                  dtype=pool.dtype, pin_memory=True)
            torch.index_select(pool, 0, idx, out=staging)
            return staging.to(self.device, non_blocking=True)
        # index_select allocates: the result never aliases the pool
        return pool.index_select(0, idx.to(pool.device))

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
