"""Paged KV storage on a LinkedBuffer — the LMB applied to serving.

A request's KV state is chopped into **KV pages** (``page_tokens`` tokens
of all layers' K+V at once) and stored as LinkedBuffer logical pages:

  * the working set of ACTIVE requests stays in the onboard (HBM) tier;
  * preempted / waiting requests' KV parks in the LMB pool (the paper's
    "exchange time for space"): admission capacity is the POOL size, not
    HBM;
  * prefix sharing = LinkedBuffer.share (zero-copy; a write to a shared
    page writes through, see repro_torch.core.buffer) — the paper's
    shared-buffer SSD→accelerator scenario;
  * swap-in cost is predicted with the tier model so the scheduler can
    decide hide-or-stall (repro_torch.core.tiers.hideable_page_bytes).

Layout per logical page: [L, 2, page_tokens, KV, hd] (K and V stacked) —
one DMA per page move, layer-major so a layer-by-layer decode can stream.

PyTorch port of ``repro.serve.kv_cache``.  The store's onboard tier lives
on ``device`` (the card's HBM on CUDA) and its LMB tier in pinned host
memory; on the CPU both are CPU tensors (modelling mode).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.api import LMBHost
from repro_torch.core.buffer import LinkedBuffer
from repro_torch.core.client import LMBSystem
from repro_torch.core.offload import TierExecutor
from repro_torch.core.overlap import OverlapScheduler


@dataclasses.dataclass
class SeqPages:
    """Page bookkeeping for one sequence."""

    seq_id: int
    pages: List[int] = dataclasses.field(default_factory=list)
    length: int = 0


@dataclasses.dataclass
class DecodeView:
    """One decode round's batched view over the paged pool.

    ``pool`` is the union of the active sequences' pages materialized
    onboard with ONE coalesced ``read_many`` burst (unpadded: eager torch
    recompiles nothing per shape); ``tables`` indexes INTO THE POOL (not
    logical page ids), so the paged-attention step can consume it
    directly.  ``pages``
    is the round's touched-page list — exactly what rides the
    schedule_prefetch / meter accounting so modeled link traffic
    reconciles with ``fm.op_bytes()``.
    """

    sids: List[int]
    pool: torch.Tensor       # [P, L, 2, T, KV, hd]
    tables: np.ndarray       # [B, MP] int32 pool indices (-1 pad)
    lengths: np.ndarray      # [B] int32 tokens stored (pre-step)
    pages: List[int]         # union logical pages backing pool[:n]
    tail_pages: List[int]    # per-sequence logical tail page
    tail_index: List[int]    # per-sequence pool index of the tail page


class PagedKVStore:
    """KV pages over a LinkedBuffer.  Construct with ``system=`` (an
    :class:`~repro_torch.core.client.LMBSystem` session — the client API) or,
    for low-level wiring, a bare ``host=`` LMBHost."""

    def __init__(self, *, cfg, host: Optional[LMBHost] = None,
                 system: Optional[LMBSystem] = None,
                 host_id: Optional[str] = None,
                 device_id: str,
                 page_tokens: int = 64, onboard_pages: int = 64,
                 n_layers: Optional[int] = None,
                 compress_cold: bool = False,
                 prefetch_depth: int = 2,
                 overlap: Optional[OverlapScheduler] = None,
                 executor: Optional[TierExecutor] = None,
                 device="cuda"):
        if host is None:
            if system is None:
                raise ValueError("PagedKVStore needs system= or host=")
            host = system.host(host_id)
        self.cfg = cfg
        L = n_layers or cfg.num_layers
        KV, hd = cfg.num_kv_heads, cfg.head_dim_
        self.page_tokens = page_tokens
        self.page_shape = (L, 2, page_tokens, KV, hd)
        self.buf = LinkedBuffer(
            name=f"kv:{device_id}", device_id=device_id, host=host,
            executor=executor or TierExecutor(device,
                                              trace=host.fm.tracer),
            page_shape=self.page_shape,
            dtype=getattr(torch, cfg.dtype), onboard_pages=onboard_pages,
            policy="cost", prefetch_depth=prefetch_depth,
            overlap=overlap, compress_lmb=compress_cold)
        self._seqs: Dict[int, SeqPages] = {}
        self._next_id = 0

    # ------------------------------------------------------------ lifecycle
    def new_seq(self) -> int:
        sid = self._next_id
        self._next_id += 1
        self._seqs[sid] = SeqPages(sid)
        return sid

    def seq(self, sid: int) -> SeqPages:
        return self._seqs[sid]

    def free_seq(self, sid: int) -> None:
        for p in self._seqs[sid].pages:
            self.buf.release(p)
        del self._seqs[sid]

    def fork(self, sid: int) -> int:
        """Zero-copy prefix share: new sequence maps the same pages — the
        Table-2 ``share`` scenario.  One batched ``share_many`` call for
        the whole prefix.  The fork's first append starts a fresh page
        when the prefix ends on a page boundary; a partial tail page is
        shared, and both sequences then write into it (the reference's
        copy-on-write does not isolate them either: the copy lands under
        the same logical index)."""
        new = self.new_seq()
        src = self._seqs[sid]
        dst = self._seqs[new]
        dst.pages = self.buf.share_many(src.pages)
        dst.length = src.length
        return new

    # ------------------------------------------------------------ data path
    def append_tokens(self, sid: int, kv: torch.Tensor) -> None:
        """kv [L, 2, T, KV, hd] for T new tokens (T <= page_tokens from
        decode; prefill calls in page-sized slabs).  Batched data path:
        the touched pages are planned up front, faulted in with ONE
        ``read_many`` burst, updated, and written back with ONE
        ``write_many`` burst — a multi-page prefill slab costs one
        coalesced transfer per LMB chunk instead of a read/write pair
        per page."""
        seq = self._seqs[sid]
        T = kv.shape[2]
        if T == 0:
            return                        # empty slab: scalar loop no-op
        # plan the page segments this slab touches
        segs = []                         # (page, token offset, take, src)
        done, length = 0, seq.length
        while done < T:
            off = length % self.page_tokens
            if off == 0:
                seq.pages.extend(self.buf.append_pages(1))
            page = seq.pages[length // self.page_tokens]
            take = min(self.page_tokens - off, T - done)
            segs.append((page, off, take, done))
            length += take
            done += take
        if len(segs) == 1:
            # decode path: one page per token — plain scalar read/write,
            # no stack/batch machinery on the hottest per-token path
            page, off, take, _ = segs[0]
            cur = self.buf.read(page)       # a copy: update it in place
            cur[:, :, off:off + take] = kv
            self.buf.write(page, cur)
            seq.length = length
            return
        pages = [s[0] for s in segs]
        cur = self.buf.read_many(pages)        # one coalesced fault burst
        for i, (page, off, take, done) in enumerate(segs):
            cur[i, :, :, off:off + take] = kv[:, :, done:done + take]
        self.buf.write_many(pages, cur)        # cur is a copy, not a pool
        seq.length = length

    def gather_seq(self, sid: int) -> torch.Tensor:
        """Materialize a sequence's KV [L, 2, seq.length, KV, hd] onboard
        (used for swap-in to a dense decode slot).  The token axis is
        trimmed to the sequence's true length — the tail page's unwritten
        slots are allocator garbage and must never reach attention (the
        silent padded return was the PR-10 bug class).  ``gather`` rides
        the batched path: one coalesced transfer per LMB chunk and one
        arbiter charge per expander link for the whole sequence."""
        seq = self._seqs[sid]
        if not seq.pages:
            return self.buf._zeros(self.page_shape)[:, :, :0]
        stacked = self.buf.gather(seq.pages)       # [n, L, 2, T, KV, hd]
        n = stacked.shape[0]
        L, _, T, KV, hd = self.page_shape
        full = torch.movedim(stacked, 0, 2).reshape(L, 2, n * T, KV, hd)
        return full[:, :, :seq.length]

    def pin_seq(self, sid: int) -> None:
        """Pin a sequence's pages onboard with ONE batched fault burst
        (a compiled step is about to DMA them)."""
        self.buf.pin_many(self._seqs[sid].pages)

    def unpin_seq(self, sid: int) -> None:
        self.buf.unpin_many(self._seqs[sid].pages)

    def next_decode_pages(self, sid: int) -> List[int]:
        """The KV pages the NEXT decode step of this sequence will touch
        — exact future knowledge for the prefetcher.  A token landing at
        a page boundary opens a fresh page (nothing to fetch); otherwise
        the partially-filled tail page is read-modified-written."""
        seq = self._seqs[sid]
        tail = seq.length // self.page_tokens
        if seq.length % self.page_tokens == 0 or tail >= len(seq.pages):
            # a fresh page, or a sequence that stores no KV (RWKV6 keeps
            # its state in the dense slot; the reference indexes past the
            # empty page list here and raises IndexError)
            return []
        return [seq.pages[tail]]

    def schedule_prefetch(self, pages: List[int]) -> None:
        """Feed a batch round's worth of scheduled page accesses to the
        buffer's prefetcher: pages move as coalesced per-(chunk,
        expander) bursts, bounded by free slots and the overlap window
        (remainder deferred, not dropped)."""
        self.buf.schedule_prefetch(pages)

    def note_compute_window(self, seconds: float,
                            observed: bool = True) -> None:
        """Report one decode round's compute time so the overlap
        scheduler can size the next prefetch window.  ``observed=False``
        pins the window exactly instead of folding the sample into the
        EWMA estimate (virtual-time sweeps with a declared round
        duration)."""
        self.buf.note_compute_window(seconds, observed=observed)

    def schedule_swap_in(self, sid: int) -> None:
        self.schedule_prefetch(self._seqs[sid].pages)

    # ----------------------------------------------------------- accounting
    def lmb_resident_pages(self) -> int:
        """KV pages currently parked in the LMB pool tier (not onboard)
        — the "concurrent sequences backed by LMB-resident KV" figure a
        load sweep reports alongside its latency table."""
        return self.buf.stats()["resident"].get("lmb", 0)

    def parked_sequences(self) -> int:
        """Sequences whose KV is entirely LMB/unmaterialized-resident —
        admitted work the onboard tier is NOT holding pages for."""
        return sum(1 for s in self._seqs.values()
                   if s.pages and not any(self.buf.tier_of(p) == "onboard"
                                          for p in s.pages))

    def stats(self) -> dict:
        st = self.buf.stats()
        st["sequences"] = len(self._seqs)
        st["page_tokens"] = self.page_tokens
        return st

    def page_table(self, sid: int, max_pages: int) -> np.ndarray:
        """int32 [max_pages] logical page ids (-1 pad) — feeds the Pallas
        paged-attention kernel on TPU.  Raises ``ValueError`` when the
        sequence has outgrown the table: the old behavior silently
        dropped the tail pages (numpy slice clamping), which would make
        attention read garbage for every token past the table edge."""
        seq = self._seqs[sid]
        if len(seq.pages) > max_pages:
            raise ValueError(
                f"seq {sid}: {len(seq.pages)} pages exceed the "
                f"{max_pages}-entry page table (length {seq.length}, "
                f"page_tokens {self.page_tokens}) — the tail KV would be "
                f"silently dropped")
        out = np.full((max_pages,), -1, np.int32)
        out[:len(seq.pages)] = seq.pages
        return out

    def page_tables(self, sids: List[int],
                    max_pages: int) -> tuple:
        """Batched decode view: (tables int32 [B, max_pages] logical page
        ids with -1 pad, lengths int32 [B]) for one engine round's active
        sequences — the host-side half of the kernel's L2P lookup.
        Raises like :meth:`page_table` instead of truncating."""
        tables = np.full((len(sids), max_pages), -1, np.int32)
        lengths = np.zeros((len(sids),), np.int32)
        for i, sid in enumerate(sids):
            tables[i] = self.page_table(sid, max_pages)
            lengths[i] = self._seqs[sid].length
        return tables, lengths

    # ------------------------------------------------------- paged decode
    def ensure_tail_page(self, sid: int) -> int:
        """Guarantee the page the sequence's NEXT token lands in exists
        (a token at a page boundary opens a fresh page); returns its
        logical id.  Allocation is logical-only — the page materializes
        on first touch."""
        seq = self._seqs[sid]
        idx = seq.length // self.page_tokens
        if len(seq.pages) == idx:
            seq.pages.extend(self.buf.append_pages(1))
        return seq.pages[idx]

    def _traced(self, name: str, access: Callable[[], object],
                pages: Callable[[object], int]):
        """``access()`` under span ``name`` (tracing on), which takes the
        ``pages`` the access touched and the ``hits``, ``misses`` and
        ``waves`` of the buffer's batched path in it; ``fault.batch`` and
        the executor's ``exec.*_pages`` spans are its children."""
        tr = self.buf.trace
        if not tr.enabled:
            return access()
        c = self.buf.metrics.tier(self.buf.name, "onboard")
        hits, misses, waves = c.hits, c.misses, self.buf.waves
        with tr.span(name, op="demand") as sid:
            out = access()
        span = tr.closed(sid)
        if span is not None:
            span.args.update(pages=pages(out), hits=c.hits - hits,
                             misses=c.misses - misses,
                             waves=self.buf.waves - waves)
        return out

    def decode_view(self, sids: List[int], max_pages: int,
                    into: Optional[Callable[[int], torch.Tensor]] = None
                    ) -> DecodeView:
        """One round's :class:`DecodeView` (:meth:`_decode_view`), under a
        ``kv.decode_view`` span with tracing on (``pages``: the union)."""
        return self._traced(
            "kv.decode_view",
            lambda: self._decode_view(sids, max_pages, into),
            lambda view: len(view.pages))

    def _decode_view(self, sids: List[int], max_pages: int,
                     into: Optional[Callable[[int], torch.Tensor]] = None
                     ) -> DecodeView:
        """Build one round's batched decode view: tail pages guaranteed,
        the union of the active sequences' pages faulted onboard with ONE
        coalesced ``read_many`` burst (metered exactly like any other
        batched access — hits for onboard-resident pages, link charges
        only for LMB misses, waves when the union exceeds onboard
        capacity), and page tables rewritten into pool-index space for
        the compiled step.  Active sequences must not share a tail page
        (the engine never forks a mid-flight sequence).  ``into(n)``, if
        given, returns the ``[n, *page_shape]`` rows the union is gathered
        into (the staged step's pool buffer, ``serve/staged.py``)."""
        for sid in sids:
            self.ensure_tail_page(sid)
        tables, lengths = self.page_tables(sids, max_pages)
        union: List[int] = []
        index: Dict[int, int] = {}
        for sid in sids:
            for p in self._seqs[sid].pages:
                if p not in index:
                    index[p] = len(union)
                    union.append(p)
        pool = self.buf.read_many(              # [n, L, 2, T, KV, hd]
            union, out=into(len(union)) if into else None)
        pool_tables = np.full_like(tables, -1)
        mapped = tables >= 0
        pool_tables[mapped] = [index[p] for p in tables[mapped].tolist()]
        tail_pages = [
            self._seqs[sid].pages[self._seqs[sid].length //
                                  self.page_tokens]
            for sid in sids]
        tail_index = [index[p] for p in tail_pages]
        return DecodeView(sids=list(sids), pool=pool,
                          tables=pool_tables,
                          lengths=lengths, pages=union,
                          tail_pages=tail_pages, tail_index=tail_index)

    def commit_decode(self, view: DecodeView, pool: torch.Tensor) -> None:
        """Write one decode round's results back: only the tail pages
        changed (the step scatters the new token's K/V there), so ONE
        ``write_many`` burst covers the whole batch, and each sequence
        advances by the token it just stored.  With tracing on, a
        ``kv.commit_decode`` span (``pages``: the tail pages)."""
        self._traced("kv.commit_decode",
                     lambda: self._commit_decode(view, pool),
                     lambda _: len(view.tail_pages))

    def _commit_decode(self, view: DecodeView, pool: torch.Tensor) -> None:
        rows = pool[view.tail_index]
        self.buf.write_many(view.tail_pages, rows)
        for sid in view.sids:
            self._seqs[sid].length += 1
