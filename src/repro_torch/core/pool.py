"""CXL expander pool model: DMPs, DPA space, and the 256 MB block allocator.

Follows the paper's §3.1/§3.2 and Fig 4:

  * The **Expander** is a GFD exposing a DPA (device physical address) space
    organized into **DMPs** (Device Media Partitions), each with a media
    attribute (DRAM or PM).
  * Hosts obtain memory from the expander in **256 MB blocks** through the
    Fabric Manager; a host-side **BlockAllocator** sub-allocates device
    requests inside those blocks and releases a block back to the FM when
    everything inside it has been freed.
  * All allocator metadata is host-resident (the paper: "We keep the memory
    allocator metadata in the host ... avoid triggering multiple CXL memory
    accesses").

This module is pure bookkeeping — no JAX.  The live backing store (JAX arrays
or host numpy) is attached by ``repro_torch.core.offload``; the discrete-event
simulator uses the same allocator with no backing store at all.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterator, List, Optional, Tuple

#: the paper's host-request granularity (§3.2)
BLOCK_BYTES = 256 * 2**20
#: sub-block allocation granularity — page-granular DMA on TPU (DESIGN.md §2);
#: CXL would allow cache-line granularity, TPU DMA wants big pages.
DEFAULT_PAGE_BYTES = 256 * 2**10


class MediaKind(enum.Enum):
    DRAM = "dram"
    PM = "pm"


class LMBError(Exception):
    """Base class for pool errors."""


class OutOfMemory(LMBError):
    pass


class InvalidHandle(LMBError):
    pass


@dataclasses.dataclass(frozen=True)
class DMP:
    """Device Media Partition: a DPA range with a media attribute (Fig 4)."""

    dmp_id: int
    media: MediaKind
    dpa_base: int
    nbytes: int

    def contains(self, dpa: int) -> bool:
        return self.dpa_base <= dpa < self.dpa_base + self.nbytes


#: block-id namespace stride per expander — keeps block ids globally unique
#: across a pooled multi-expander fabric (an expander never hands out more
#: than BLOCK_ID_STRIDE blocks; 2**20 blocks = 256 TiB per expander)
BLOCK_ID_STRIDE = 1 << 20


@dataclasses.dataclass
class BlockGrant:
    """A 256 MB block granted by the FM to one host."""

    block_id: int
    dmp_id: int
    dpa_base: int
    host_id: str
    nbytes: int = BLOCK_BYTES
    #: which expander in the FM's pooled set backs this block
    expander_id: int = 0
    #: media of the backing DMP — a failover re-grant must match it
    media: MediaKind = MediaKind.DRAM


class Expander:
    """A GFD memory expander: DMPs + block-granular grants to hosts.

    The expander only hands out whole blocks; fine-grained allocation is the
    host allocator's job.  It also implements the HPA→DPA translation the
    paper's Fig 4 shows (identity-with-offset per grant here).

    ``expander_id`` names the expander inside a pooled fabric; block ids are
    carved from a per-expander namespace (``expander_id * BLOCK_ID_STRIDE``)
    so grants from different expanders never collide in the FM's tables.
    """

    def __init__(self, dmps: List[Tuple[MediaKind, int]],
                 expander_id: int = 0):
        base = 0
        self._dmps: List[DMP] = []
        for i, (media, nbytes) in enumerate(dmps):
            if nbytes % BLOCK_BYTES:
                raise ValueError("DMP size must be a multiple of BLOCK_BYTES")
            self._dmps.append(DMP(i, media, base, nbytes))
            base += nbytes
        # free block DPA bases per DMP
        self._free: Dict[int, List[int]] = {
            d.dmp_id: list(range(d.dpa_base, d.dpa_base + d.nbytes,
                                 BLOCK_BYTES))
            for d in self._dmps
        }
        self._grants: Dict[int, BlockGrant] = {}
        self.expander_id = expander_id
        self._next_block_id = expander_id * BLOCK_ID_STRIDE
        self.failed = False  # failure-injection flag (see fabric.py)

    def renumber(self, expander_id: int) -> None:
        """Move this expander to another block-id namespace.  Only legal
        before any grant — outstanding block ids would keep the old
        namespace and collide with the FM's placement tables."""
        if self._grants:
            raise LMBError(
                f"cannot renumber expander {self.expander_id}: "
                f"{len(self._grants)} blocks outstanding")
        self.expander_id = expander_id
        self._next_block_id = expander_id * BLOCK_ID_STRIDE

    def reset(self) -> None:
        """Blank-media repair: forget every grant and rebuild the free
        lists (the FRU was swapped — its contents are gone).  The
        block-id counter is NOT rewound: ids from before the reset never
        come back, so stale references cannot alias post-repair grants.
        The FM's ``readmit_expander`` is the only caller; it also clears
        ``failed`` and purges its own tables."""
        self._grants.clear()
        self._free = {
            d.dmp_id: list(range(d.dpa_base, d.dpa_base + d.nbytes,
                                 BLOCK_BYTES))
            for d in self._dmps
        }

    # -- capacity ----------------------------------------------------------
    @property
    def total_bytes(self) -> int:
        return sum(d.nbytes for d in self._dmps)

    def free_bytes(self, media: Optional[MediaKind] = None) -> int:
        total = 0
        for d in self._dmps:
            if media is not None and d.media is not media:
                continue
            total += len(self._free[d.dmp_id]) * BLOCK_BYTES
        return total

    # -- block grant / release (FM-mediated) --------------------------------
    def grant_block(self, host_id: str,
                    media: MediaKind = MediaKind.DRAM) -> BlockGrant:
        if self.failed:
            raise LMBError("expander failed")
        if self._next_block_id >= (self.expander_id + 1) * BLOCK_ID_STRIDE:
            raise LMBError(
                f"expander {self.expander_id} exhausted its block-id "
                f"namespace ({BLOCK_ID_STRIDE} grants)")
        for d in self._dmps:
            if d.media is media and self._free[d.dmp_id]:
                dpa = self._free[d.dmp_id].pop()
                grant = BlockGrant(self._next_block_id, d.dmp_id, dpa, host_id,
                                   expander_id=self.expander_id, media=media)
                self._next_block_id += 1
                self._grants[grant.block_id] = grant
                return grant
        raise OutOfMemory(
            f"expander out of {media.value} blocks "
            f"(free={self.free_bytes(media)})")

    def release_block(self, block_id: int) -> None:
        grant = self._grants.pop(block_id, None)
        if grant is None:
            raise InvalidHandle(f"unknown block {block_id}")
        self._free[grant.dmp_id].append(grant.dpa_base)

    def grants_for(self, host_id: str) -> List[BlockGrant]:
        return [g for g in self._grants.values() if g.host_id == host_id]

    def translate(self, block_id: int, offset: int) -> int:
        """HPA-relative (block, offset) → DPA (Fig 4 address mapping)."""
        grant = self._grants.get(block_id)
        if grant is None:
            raise InvalidHandle(f"unknown block {block_id}")
        if not 0 <= offset < grant.nbytes:
            raise InvalidHandle(
                f"offset {offset} outside block {block_id}")
        return grant.dpa_base + offset


@dataclasses.dataclass
class Region:
    """A page-aligned sub-block allocation owned by one device (mmid)."""

    mmid: int
    block_id: int
    page_start: int       # first page index within the block
    npages: int
    page_bytes: int
    owner: str            # device id

    @property
    def nbytes(self) -> int:
        return self.npages * self.page_bytes

    @property
    def offset(self) -> int:
        return self.page_start * self.page_bytes


class _BlockState:
    """Host-side per-block page bitmap (next-fit contiguous runs).

    Next-fit with a rotating hint + free-page counter: O(1) rejection of
    full blocks and amortized-short scans keep the Table-2 alloc path in
    the microsecond range (benchmarks/run.py::allocator)."""

    __slots__ = ("grant", "page_bytes", "npages", "used", "free_pages",
                 "_hint")

    def __init__(self, grant: BlockGrant, page_bytes: int):
        self.grant = grant
        self.page_bytes = page_bytes
        self.npages = grant.nbytes // page_bytes
        self.used = bytearray(self.npages)  # 0 = free, 1 = used
        self.free_pages = self.npages
        self._hint = 0

    def _scan(self, start: int, stop: int, npages: int) -> Optional[int]:
        run = 0
        for i in range(start, stop):
            run = 0 if self.used[i] else run + 1
            if run == npages:
                return i - npages + 1
        return None

    def find_run(self, npages: int) -> Optional[int]:
        if npages > self.free_pages:
            return None
        pos = self._scan(self._hint, self.npages, npages)
        if pos is None and self._hint:
            pos = self._scan(0, min(self._hint + npages, self.npages),
                             npages)
        return pos

    def mark(self, start: int, npages: int, used: bool) -> None:
        val = 1 if used else 0
        for i in range(start, start + npages):
            if self.used[i] == val:
                raise LMBError(
                    f"page {i} already {'used' if used else 'free'}")
            self.used[i] = val
        self.free_pages += -npages if used else npages
        if used:
            self._hint = start + npages
        else:
            self._hint = min(self._hint, start)

    @property
    def used_pages(self) -> int:
        return self.npages - self.free_pages


class BlockAllocator:
    """Host-side allocator sub-allocating device requests inside FM blocks.

    ``request_block`` / ``return_block`` are callbacks into the Fabric
    Manager; the allocator asks for one block at a time when it cannot
    satisfy a request (paper §3.2) and returns a block as soon as it is
    entirely free.  ``request_block(expander_id, owner)`` takes an
    optional expander hint so placement-aware callers (hot-page
    migration) can direct a region onto a specific expander's blocks,
    plus the requesting device so the FM's placement policy can key on
    its tenant (repro_torch.core.placement).
    """

    def __init__(self, request_block, return_block,
                 page_bytes: int = DEFAULT_PAGE_BYTES):
        if BLOCK_BYTES % page_bytes:
            raise ValueError("page_bytes must divide BLOCK_BYTES")
        self._request_block = request_block
        self._return_block = return_block
        self.page_bytes = page_bytes
        self._blocks: Dict[int, _BlockState] = {}
        self._regions: Dict[int, Region] = {}
        self._next_mmid = 1

    # -- queries -------------------------------------------------------------
    @property
    def regions(self) -> Dict[int, Region]:
        return dict(self._regions)

    @property
    def block_count(self) -> int:
        return len(self._blocks)

    def owned_bytes(self, owner: str) -> int:
        return sum(r.nbytes for r in self._regions.values()
                   if r.owner == owner)

    def utilization(self) -> float:
        if not self._blocks:
            return 0.0
        used = sum(b.used_pages for b in self._blocks.values())
        total = sum(b.npages for b in self._blocks.values())
        return used / total

    # -- alloc / free ---------------------------------------------------------
    def _pages_for(self, nbytes: int) -> int:
        if nbytes <= 0:
            raise ValueError("allocation size must be positive")
        return -(-nbytes // self.page_bytes)

    def alloc(self, owner: str, nbytes: int,
              expander_id: Optional[int] = None) -> Region:
        """Allocate a region; ``expander_id`` restricts it to blocks backed
        by that expander (placement hint for migration/striping)."""
        npages = self._pages_for(nbytes)
        if npages > BLOCK_BYTES // self.page_bytes:
            return self._alloc_multiblock(owner, npages)
        for bs in self._blocks.values():
            if (expander_id is not None
                    and bs.grant.expander_id != expander_id):
                continue
            start = bs.find_run(npages)
            if start is not None:
                return self._commit(owner, bs, start, npages)
        # no room: request one more block from the FM (paper §3.2)
        grant = self._request_block(expander_id, owner)
        bs = _BlockState(grant, self.page_bytes)
        self._blocks[grant.block_id] = bs
        start = bs.find_run(npages)
        assert start is not None
        return self._commit(owner, bs, start, npages)

    def _alloc_multiblock(self, owner: str, npages: int) -> Region:
        # Large allocations (> one block) are split by the caller layer
        # (LinkedBuffer pages never exceed a block); reject here to keep the
        # DPA-contiguity invariant that a Region lives inside one block.
        raise OutOfMemory(
            f"single region of {npages} pages exceeds one {BLOCK_BYTES}-byte "
            "block; allocate per-page via LinkedBuffer instead")

    def _commit(self, owner: str, bs: _BlockState, start: int,
                npages: int) -> Region:
        bs.mark(start, npages, True)
        region = Region(self._next_mmid, bs.grant.block_id, start, npages,
                        self.page_bytes, owner)
        self._next_mmid += 1
        self._regions[region.mmid] = region
        return region

    def free(self, mmid: int, owner: Optional[str] = None) -> None:
        region = self._regions.pop(mmid, None)
        if region is None:
            raise InvalidHandle(f"unknown mmid {mmid}")
        if owner is not None and region.owner != owner:
            self._regions[mmid] = region
            raise LMBError(
                f"device {owner!r} cannot free mmid {mmid} owned by "
                f"{region.owner!r}")
        bs = self._blocks[region.block_id]
        bs.mark(region.page_start, region.npages, False)
        if bs.used_pages == 0:
            # whole block free → return to the FM (paper §3.2)
            del self._blocks[region.block_id]
            self._return_block(region.block_id)

    def region(self, mmid: int) -> Region:
        r = self._regions.get(mmid)
        if r is None:
            raise InvalidHandle(f"unknown mmid {mmid}")
        return r

    def expander_of(self, mmid: int) -> int:
        """Which pooled expander backs this region's block."""
        region = self.region(mmid)
        return self._blocks[region.block_id].grant.expander_id

    def adopt_block(self, grant: BlockGrant) -> bool:
        """Start tracking a block the FM granted out-of-band (a blank
        failover replacement): it joins empty and its free runs satisfy
        future allocations, so re-granted capacity stays usable and the
        block can eventually be returned.  No-op for known blocks."""
        if grant.block_id in self._blocks:
            return False
        self._blocks[grant.block_id] = _BlockState(grant, self.page_bytes)
        return True

    def drop_expander(self, expander_id: int) -> List[int]:
        """Forget every block (and the regions inside) backed by a failed
        expander.  Called on failover: the FM already re-granted or lost
        those blocks, so nothing is returned to it — without this, the
        dead blocks' free runs would keep satisfying new allocations and
        silently place fresh regions on the failed expander.  Returns the
        dropped mmids."""
        dead = {bid for bid, bs in self._blocks.items()
                if bs.grant.expander_id == expander_id}
        for bid in dead:
            del self._blocks[bid]
        dropped = [mmid for mmid, r in self._regions.items()
                   if r.block_id in dead]
        for mmid in dropped:
            del self._regions[mmid]
        return dropped

    def iter_regions(self) -> Iterator[Region]:
        return iter(self._regions.values())
