"""Paged decode attention — the CUDA kernel, its plain version, a wrapper.

Port of ``repro.kernels.paged_attention``.  The kernels
(``csrc/paged_attention.cu``) replace the Pallas TPU kernel
``paged_attention``, whose grid (B, KV) walks each row's pages in order.
Here the pages of each row are split over blocks: a split kernel with grid
(B, KV, n_splits) scores each block's range of page-table columns with an
online softmax in f32 registers and writes a partial (m, l, acc), and a
combine kernel merges the partials per (row, head) by log-sum-exp.
:func:`split_plan` chooses the splits on the host from the grid's other
axes, the page-table width and the card's SM count, never from ``lengths``
(which lives on the card).

:func:`paged_attention_plain` mirrors ``paged_attention_xla`` op for op
(the same einsum order, f32 scores with the scale applied after, -1e30
masking, probabilities cast to V's dtype, zeros for rows of length 0).
The CPU path and the tests use it; ``chip_smoke.py`` holds the kernel
against it on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.cuda_build import H100_SXM_SMS, sm_count

NEG_INF = -1e30
BLOCKS_PER_SM = 2       # the split kernel's target occupancy of the grid
MAX_G = 8               # query heads one split block scores (kMaxG)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def split_plan(B: int, KV: int, MP: int, *, G: int = 1,
               sm_count: int = H100_SXM_SMS) -> Tuple[int, int]:
    """``(n_splits, pages_per_split)`` for a batch of B rows, KV kv heads
    of G query heads each and a page table MP columns wide: split s takes
    the columns ``[s * pages_per_split, min((s + 1) * pages_per_split,
    MP))``.  Aims at about ``BLOCKS_PER_SM`` blocks per SM over the split
    kernel's grid (B, KV * ceil(G / MAX_G), n_splits), and no trailing
    split without a column."""
    blocks = B * KV * -(-G // MAX_G)
    want = -(-sm_count * BLOCKS_PER_SM // max(1, blocks))
    n = max(1, min(MP, want))
    per = max(1, -(-MP // n))
    return max(1, -(-MP // per)), per


def paged_attention_plain(q, k_pages, v_pages, page_table, lengths,
                          *, scale_override: Optional[float] = None):
    """q [B,H,hd]; k/v_pages [P,T,KV,hd]; page_table [B,MP] int32 (-1 =
    unmapped); lengths [B] -> out [B,H,hd] in q's dtype."""
    B, H, hd = q.shape
    P, T, KV, _ = k_pages.shape
    MP = page_table.shape[1]
    G = H // KV
    scale = 1.0 / math.sqrt(hd) if scale_override is None else \
        scale_override
    safe = page_table.clamp(min=0).long()
    k = k_pages[safe].reshape(B, MP * T, KV, hd)
    v = v_pages[safe].reshape(B, MP * T, KV, hd)
    qg = q.reshape(B, 1, KV, G, hd)
    pos = torch.arange(MP * T, device=q.device)[None, :]
    valid = (pos < lengths[:, None]) & \
        torch.repeat_interleave(page_table >= 0, T, dim=1)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * scale
    s = s.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    # all-masked rows (length 0): softmax degenerates to uniform over
    # NEG_INF lanes; zero them like the kernel does
    any_valid = valid.any(dim=1)[:, None, None, None, None]
    o = o.masked_fill(~any_valid, 0.0)
    return o.reshape(B, H, hd).to(q.dtype)


def _check(cond: bool, msg) -> None:
    """Raise unless ``cond``; ``msg`` is a string or, where it needs
    formatting, a function that makes it (called only on failure: the
    wrappers are on the serve path's host time)."""
    if not cond:
        raise ValueError(f"paged_attention: {msg() if callable(msg) else msg}")


def paged_attention_cuda(q, k_pages, v_pages, page_table, lengths,
                         *, scale_override: Optional[float] = None):
    """Launch the CUDA kernels; same contract as the plain version.

    ``k_pages``/``v_pages`` may be strided views (e.g. ``pool[:, l, 0]``
    of the serving pool) as long as each head's ``hd`` values are
    contiguous and the views start and step on 16-byte boundaries (the
    kernel reads 16-byte vectors).  Raises on anything the kernel does not
    take.  Counts one launch per call (a split and a combine kernel)."""
    _check(q.is_cuda, "q must be a CUDA tensor")
    dev = q.device
    tensors = (k_pages, v_pages, page_table, lengths)
    _check(all(t.device == dev for t in tensors),
           lambda: f"k_pages, v_pages, page_table and lengths on "
           f"{[str(t.device) for t in tensors]}, q on {dev}")
    _check(q.dtype in _DTYPES,
           lambda: f"dtype {q.dtype} (float32 or bfloat16)")
    _check(k_pages.dtype == q.dtype and v_pages.dtype == q.dtype,
           "q, k_pages and v_pages must share a dtype")
    _check(q.dim() == 3 and q.is_contiguous(), "q must be [B,H,hd], "
           "contiguous")
    B, H, hd = q.shape
    _check(k_pages.dim() == 4 and k_pages.shape == v_pages.shape,
           "k_pages/v_pages must both be [P,T,KV,hd]")
    P, T, KV, hd_k = k_pages.shape
    _check(hd_k == hd, lambda: f"head_dim {hd_k} != q's {hd}")
    _check(cuda_build.head_dim_ok(hd),
           lambda: f"head_dim {hd} ({cuda_build.HEAD_DIM_RULE})")
    _check(KV > 0 and H % KV == 0, lambda: f"{H} heads over {KV} kv heads")
    k_st, v_st = k_pages.stride(), v_pages.stride()
    _check(k_st[3] == 1 and v_st[3] == 1,
           "the head_dim axis of the pools must be contiguous")
    _check(page_table.dtype == torch.int32 and page_table.dim() == 2
           and page_table.shape[0] == B and page_table.is_contiguous(),
           "page_table must be contiguous int32 [B,MP]")
    _check(lengths.dtype == torch.int32 and tuple(lengths.shape) == (B,)
           and lengths.is_contiguous(), "lengths must be contiguous "
           "int32 [B]")
    per_vec = 16 // q.element_size()
    _check(k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0
           and all(st % per_vec == 0 for st in k_st[:3] + v_st[:3]),
           "k_pages and v_pages must start and step on 16-byte boundaries")
    out = torch.empty_like(q)
    if B == 0 or P == 0:
        return out.zero_()
    scale = 1.0 / math.sqrt(hd) if scale_override is None else \
        scale_override
    MP = page_table.shape[1]
    n_splits, per = split_plan(B, KV, MP, G=H // KV,
                               sm_count=sm_count(dev))
    part = torch.empty(B * H * n_splits * (hd + 2), dtype=torch.float32,
                       device=dev)
    lib = _lib()
    err = lib.paged_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part.data_ptr(),
        part.data_ptr() + 4 * B * H * n_splits * hd, B, H, KV, hd, T, MP,
        n_splits, per, *k_st[:3], *v_st[:3],
        float(scale), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {err}")
    cuda_build.count_launch("paged_attention")
    return out


def _lib():
    lib = cuda_build.load("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       i64, i64, i64, i64, i64, i64, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib

