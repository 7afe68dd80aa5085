"""Latent attention's absorbed decode — the CUDA kernels, their plain
version, a wrapper.

The kernels (``csrc/mla_decode.cu``) replace no TPU kernel: the JAX
package has no latent attention.  They were added for DeepSeek-V3's
paged decode (``models/mla.py``), where every query head of a row reads
the same cached rows: 576 columns a token and layer (the 512-wide latent
and the 64-wide RoPE key), of which the first 512 are also the values.
A split kernel scores each split of a row's live pages for one tile of 64
query heads with an online softmax in f32 and writes a partial (m, l,
acc[512]); a combine kernel merges a row's partials per head by
log-sum-exp.  The splits follow the live pages, counted on the card from
``lengths``, so the launch depends on (B, H, MP) alone and a CUDA graph
replays it for any lengths (:func:`split_plan`).

:func:`mla_decode_plain` is the same function op for op in the
``paged_attention_plain`` manner: f32 scores scaled after the
contraction, -1e30 masking, probabilities cast to the rows' dtype, zeros
for a row of length 0.  The CPU path and the tests use it;
``chip_smoke.py`` and the card tests hold the kernels against it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.cuda_build import H100_SXM_SMS, sm_count

NEG_INF = -1e30
#: the widths the kernels are built for: a cached row and its value part
ROW_WIDTH = 576
V_WIDTH = 512
#: query heads one block of the split kernel holds
HEAD_TILE = 64
#: splits a row may have: the combine kernel's limit
MAX_SPLITS = 512
#: the plan aims at this many (row, split, head tile) units an SM when
#: every page of the table is live, so a batch of shorter rows still
#: gives each SM a few
UNITS_PER_SM = 4
#: ``cuda_build.LAUNCHES`` name of the kernels' calls
LAUNCHES = "mla_decode"


@functools.lru_cache(maxsize=None)
def split_plan(B: int, H: int, MP: int, *,
               sm_count: int = H100_SXM_SMS) -> Tuple[int, int]:
    """``(n_splits, pages_per_split)`` for B rows of H heads and a page
    table MP columns wide: split s of a row takes its columns ``[s *
    pages_per_split, (s + 1) * pages_per_split)``.  A full table gives
    ``UNITS_PER_SM`` units an SM; a split holds at least one page and a
    row at most ``MAX_SPLITS``."""
    tiles = -(-H // HEAD_TILE)
    per = -(-B * tiles * MP // (UNITS_PER_SM * sm_count))
    per = max(1, per, -(-MP // MAX_SPLITS))
    return -(-MP // per), per


def mla_decode_plain(q, pages, page_table, lengths, *, scale: float,
                     v_width: int):
    """q [B,H,Dk]; pages [P,T,Dk]; page_table [B,MP] int32 (-1 =
    unmapped); lengths [B] -> out [B,H,v_width] in q's dtype: softmax(q .
    row * scale) over each row's first ``lengths`` tokens, times the rows'
    first ``v_width`` columns."""
    B, H, Dk = q.shape
    T = pages.shape[1]
    MP = page_table.shape[1]
    rows = pages[page_table.clamp(min=0).long()].reshape(B, MP * T, Dk)
    pos = torch.arange(MP * T, device=q.device)[None, :]
    valid = (pos < lengths[:, None]) & \
        torch.repeat_interleave(page_table >= 0, T, dim=1)
    s = torch.einsum("bhd,bsd->bhs", q.float(), rows.float()) * scale
    s = s.masked_fill(~valid[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhs,bsd->bhd", p.to(rows.dtype), rows[..., :v_width])
    o = o.masked_fill(~valid.any(dim=1)[:, None, None], 0.0)
    return o.to(q.dtype)


def _check(cond: bool, msg) -> None:
    if not cond:
        raise ValueError(f"mla_decode: {msg() if callable(msg) else msg}")


def mla_decode_cuda(q, pages, page_table, lengths, *, scale: float,
                    v_width: int):
    """Launch the CUDA kernels; same contract as the plain version, in
    bf16 at ``ROW_WIDTH`` and ``V_WIDTH``.  ``pages`` may be a strided
    view (``pool[:, l]`` of the serving pool [P, L, T, 576]) whose rows
    are contiguous and whose base and strides are multiples of 16 bytes.
    Counts one launch (a split and a combine kernel) as ``LAUNCHES``."""
    _check(q.is_cuda, "q must be a CUDA tensor")
    dev = q.device
    tensors = (pages, page_table, lengths)
    _check(all(t.device == dev for t in tensors),
           lambda: f"pages, page_table and lengths on "
           f"{[str(t.device) for t in tensors]}, q on {dev}")
    _check(q.dtype == torch.bfloat16 and pages.dtype == torch.bfloat16,
           lambda: f"q {q.dtype} and pages {pages.dtype} (bfloat16)")
    _check(q.dim() == 3 and q.is_contiguous() and q.shape[2] == ROW_WIDTH,
           lambda: f"q {tuple(q.shape)} must be contiguous [B,H,"
           f"{ROW_WIDTH}]")
    _check(v_width == V_WIDTH, lambda: f"v_width {v_width} ({V_WIDTH})")
    _check(pages.dim() == 3 and pages.shape[2] == ROW_WIDTH
           and pages.stride(2) == 1,
           lambda: f"pages {tuple(pages.shape)} must be [P,T,{ROW_WIDTH}] "
           f"with contiguous rows")
    B, H, _ = q.shape
    P, T, _ = pages.shape
    _check(page_table.dtype == torch.int32 and page_table.dim() == 2
           and page_table.shape[0] == B and page_table.is_contiguous(),
           "page_table must be contiguous int32 [B,MP]")
    _check(lengths.dtype == torch.int32 and tuple(lengths.shape) == (B,)
           and lengths.is_contiguous(), "lengths must be contiguous "
           "int32 [B]")
    sp, st = pages.stride(0), pages.stride(1)
    _check(pages.data_ptr() % 16 == 0 and sp % 8 == 0 and st % 8 == 0,
           "pages must start and step on 16-byte boundaries")
    out = q.new_empty((B, H, V_WIDTH))
    if B == 0 or P == 0:
        return out.zero_()
    MP = page_table.shape[1]
    sms = sm_count(dev)
    n_splits, per = split_plan(B, H, MP, sm_count=sms)
    n = B * H * n_splits
    part = torch.empty(n * (V_WIDTH + 2), dtype=torch.float32, device=dev)
    err = _lib().mla_decode_launch(
        q.data_ptr(), pages.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
        part.data_ptr() + 4 * n * V_WIDTH, B, H, T, MP, n_splits, per, sp,
        st, float(scale), sms, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mla_decode kernel launch failed: cudaError "
                           f"{err}")
    cuda_build.count_launch(LAUNCHES)
    return out


def _lib():
    lib = cuda_build.load("mla_decode")
    fn = lib.mla_decode_launch
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i64, i64,
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib
