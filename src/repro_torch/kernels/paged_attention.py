"""Paged decode attention — the CUDA kernels, their plain version, a wrapper.

Port of ``repro.kernels.paged_attention``.  The kernels
(``csrc/paged_attention.cu``) replace the Pallas TPU kernel
``paged_attention``, whose grid (B, KV) walks each row's pages in order.
Here each row's pages are cut into splits of :func:`split_plan`'s
``pages_per_split``; a split kernel scores each split with an online
softmax in f32 and writes a partial (m, l, acc), and a combine kernel
merges the partials per (row, head) by log-sum-exp.  The wrapper routes by
dtype and head_dim (:func:`uses_tensor_cores`): bf16 up to
``MMA_MAX_HEAD_DIM`` runs the tensor-core split kernel, which scores all
G query heads of a kv head as ``mma.sync`` tiles and reads each live page
once per (row, kv head), on a persistent grid that walks the live splits
it counts from ``lengths`` on the card; f32 (whose tensor-core form would
be TF32) and wider bf16 heads run the CUDA-core split kernel over every
split of the page table.  The plan is chosen on the host from the page
size, G and the page table's width, never from ``lengths`` (which lives on
the card), so a CUDA graph replays one launch for any lengths.

:func:`paged_attention_plain` mirrors ``paged_attention_xla`` op for op
(the same einsum order, f32 scores with the scale applied after, -1e30
masking, probabilities cast to V's dtype, zeros for rows of length 0).
The CPU path and the tests use it; ``chip_smoke.py`` holds the kernels
against it on the card.

``window`` (tokens, 0 = none) limits each row of n tokens to its last
``window`` keys, ``n - window`` on: the windowed layers of a model whose
layers differ (``ArchConfig.window_pattern``).  The kernels then start a
row's splits at the page that holds its first key, and the plan counts
the pages a window can touch (:func:`window_columns`) in place of the page
table's width; at 0 the plan and the launch are the ones without it.
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
MAX_SPLITS = 512        # splits a row may have: the combine kernel's limit
#: tokens a split holds per query head it serves: a split of one kv head
#: reads 4 hd bytes of bf16 K and V a token and writes 4 (hd + 2) bytes of
#: f32 partial a head, so its partials stay under a quarter of its reads
SPLIT_TOKENS_PER_HEAD = 4
#: the fewest tokens a split holds: four 32-token tiles of the tensor-core
#: kernel, so a split's fixed cost (finding its row, q, the first copies,
#: the partial's write) stays about a fifth of its time
MIN_SPLIT_TOKENS = 128
#: a page table of which one column in MIN_LIVE_SHARE is live still gives
#: every SM a split: a small table (a short max_seq_len, a small batch)
#: takes smaller splits
MIN_LIVE_SHARE = 4
#: the widest head_dim of the tensor-core split kernel (its instantiations:
#: 64 and 128, narrower head_dims zero-padded up to one)
MMA_MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: ``cuda_build.LAUNCHES`` names of the two split kernels' calls (each
#: call also counts once as ``paged_attention``)
MMA_LAUNCHES = "paged_attention.tensor_cores"
CUDA_CORE_LAUNCHES = "paged_attention.cuda_cores"
#: and of the calls with a window, on either route
WINDOWED_LAUNCHES = "paged_attention.windowed"


def window_columns(MP: int, T: int, window: int) -> int:
    """Page-table columns a row's attended keys can span: all ``MP``
    without a window, else the pages ``window`` keys starting anywhere in
    a page reach, ``ceil((window + T - 1) / T)``."""
    return MP if window <= 0 else min(MP, -(-(window + T - 1) // T))


def pages_read(lengths, T: int, window: int = 0) -> int:
    """Pages one layer's call reads for rows of ``lengths`` tokens (the
    new one included): each row's pages from the one holding its first
    attended key to the one holding its last."""
    total = 0
    for n in lengths:
        n = int(n)
        if n > 0:
            lo = max(0, n - window) if window > 0 else 0
            total += (n - 1) // T - lo // T + 1
    return total


@functools.lru_cache(maxsize=None)
def split_plan(B: int, KV: int, MP: int, *, T: int, G: int = 1,
               sm_count: int = H100_SXM_SMS) -> Tuple[int, int]:
    """``(n_splits, pages_per_split)`` for a batch of B rows, KV kv heads
    of G query heads each, pages of T tokens and a page table MP columns
    wide: split s of a row takes its columns ``[s * pages_per_split,
    min((s + 1) * pages_per_split, MP))``, and a row of n tokens has
    ``ceil(min(n, MP * T) / (pages_per_split * T))`` live splits.

    ``pages_per_split`` follows the page size and G (at least
    ``SPLIT_TOKENS_PER_HEAD * G`` and ``MIN_SPLIT_TOKENS`` tokens), not the
    page table's width, so the live splits follow the live pages.  It
    shrinks where a table with one column in ``MIN_LIVE_SHARE`` live would
    give fewer splits than the card has SMs, and grows where a row would
    pass ``MAX_SPLITS``."""
    per = -(-max(SPLIT_TOKENS_PER_HEAD * G, MIN_SPLIT_TOKENS) // T)
    per = min(per, B * KV * MP // (MIN_LIVE_SHARE * sm_count))
    per = max(1, per, -(-MP // MAX_SPLITS))
    return max(1, -(-MP // per)), per


def uses_tensor_cores(dtype: torch.dtype, hd: int) -> bool:
    """The wrapper's route: bf16 at head_dim <= ``MMA_MAX_HEAD_DIM`` runs
    the tensor-core split kernel, everything else the CUDA-core one."""
    return dtype == torch.bfloat16 and hd <= MMA_MAX_HEAD_DIM


def paged_attention_plain(q, k_pages, v_pages, page_table, lengths,
                          *, scale_override: Optional[float] = None,
                          window: int = 0):
    """q [B,H,hd]; k/v_pages [P,T,KV,hd]; page_table [B,MP] int32 (-1 =
    unmapped); lengths [B] -> out [B,H,hd] in q's dtype.  ``window`` > 0
    keeps each row's keys from ``lengths - window`` on."""
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
    if window > 0:
        valid &= pos >= lengths[:, None] - window
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
                         *, scale_override: Optional[float] = None,
                         window: int = 0):
    """Launch the CUDA kernels; same contract as the plain version.

    ``k_pages``/``v_pages`` may be strided views (e.g. ``pool[:, l, 0]``
    of the serving pool) as long as each head's ``hd`` values are
    contiguous and the views start and step on 16-byte boundaries (the
    kernel reads 16-byte vectors).  Raises on anything the kernels do not
    take.  Counts one launch per call (a split and a combine kernel) as
    ``paged_attention``, once more under the route's name
    (``MMA_LAUNCHES`` or ``CUDA_CORE_LAUNCHES``), and with a window once
    as ``WINDOWED_LAUNCHES``."""
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
    _check(isinstance(window, int) and window >= 0,
           lambda: f"window {window!r} (an int, 0 for none)")
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
    sms = sm_count(dev)
    n_splits, per = split_plan(B, KV, window_columns(MP, T, window), T=T,
                               G=H // KV, sm_count=sms)
    part = torch.empty(B * H * n_splits * (hd + 2), dtype=torch.float32,
                       device=dev)
    lib = _lib()
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part.data_ptr(), part.data_ptr() + 4 * B * H * n_splits * hd,
            B, H, KV, hd, T, MP, n_splits, per, *k_st[:3], *v_st[:3],
            float(scale), window)
    stream = torch.cuda.current_stream(dev).cuda_stream
    mma = uses_tensor_cores(q.dtype, hd)
    if mma:
        err = lib.paged_attention_mma_launch(*args, sms, stream)
    else:
        err = lib.paged_attention_launch(_DTYPES[q.dtype], *args, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {err}")
    cuda_build.count_launch("paged_attention")
    cuda_build.count_launch(MMA_LAUNCHES if mma else CUDA_CORE_LAUNCHES)
    if window:
        cuda_build.count_launch(WINDOWED_LAUNCHES)
    return out


def _lib():
    lib = cuda_build.load("paged_attention")
    if lib.paged_attention_launch.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        common = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                  i64, i64, i64, i64, i64, i64, ctypes.c_float, i]
        lib.paged_attention_mma_launch.argtypes = common + [i, p]
        lib.paged_attention_mma_launch.restype = ctypes.c_int
        lib.paged_attention_launch.argtypes = [i] + common + [p]
        lib.paged_attention_launch.restype = ctypes.c_int
    return lib
