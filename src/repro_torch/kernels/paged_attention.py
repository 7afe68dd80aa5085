"""Paged decode attention — the CUDA kernel, its plain version, a wrapper.

Port of ``repro.kernels.paged_attention``.  The kernel
(``csrc/paged_attention.cu``) replaces the Pallas TPU kernel
``paged_attention``: one block per (batch row, kv head) walks the row's
live pages through its page-table row, staging each page's K/V in shared
memory and keeping the G query heads' online-softmax state in f32.

:func:`paged_attention_plain` mirrors ``paged_attention_xla`` op for op
(the same einsum order, f32 scores with the scale applied after, -1e30
masking, probabilities cast to V's dtype, zeros for rows of length 0).
The CPU path and the tests use it; ``chip_smoke.py`` holds the kernel
against it on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import cuda_build

NEG_INF = -1e30
MAX_SMEM_BYTES = 232448
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention: {msg}")


def smem_bytes(G: int, T: int, hd: int) -> int:
    """Dynamic shared memory one block of the kernel takes."""
    return 4 * (T * (hd + 1) + T * hd + 2 * G * hd + G * T + 3 * G)


def paged_attention_cuda(q, k_pages, v_pages, page_table, lengths,
                         *, scale_override: Optional[float] = None):
    """Launch the CUDA kernel; same contract as the plain version.

    ``k_pages``/``v_pages`` may be strided views (e.g. ``pool[:, l, 0]``
    of the serving pool) as long as each head's ``hd`` values are
    contiguous.  Raises on anything the kernel does not take."""
    _check(q.is_cuda, "q must be a CUDA tensor")
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        _check(t.device == dev, f"{name} on {t.device}, q on {dev}")
    _check(q.dtype in _DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    _check(k_pages.dtype == q.dtype and v_pages.dtype == q.dtype,
           "q, k_pages and v_pages must share a dtype")
    _check(q.dim() == 3 and q.is_contiguous(), "q must be [B,H,hd], "
           "contiguous")
    B, H, hd = q.shape
    _check(k_pages.dim() == 4 and k_pages.shape == v_pages.shape,
           "k_pages/v_pages must both be [P,T,KV,hd]")
    P, T, KV, hd_k = k_pages.shape
    _check(hd_k == hd, f"head_dim {hd_k} != q's {hd}")
    _check(hd % 16 == 0 and 16 <= hd <= 256, f"head_dim {hd} (16..256, "
           "a multiple of 16)")
    _check(KV > 0 and H % KV == 0, f"{H} heads over {KV} kv heads")
    _check(k_pages.stride(-1) == 1 and v_pages.stride(-1) == 1,
           "the head_dim axis of the pools must be contiguous")
    _check(page_table.dtype == torch.int32 and page_table.dim() == 2
           and page_table.shape[0] == B and page_table.is_contiguous(),
           "page_table must be contiguous int32 [B,MP]")
    _check(lengths.dtype == torch.int32 and tuple(lengths.shape) == (B,)
           and lengths.is_contiguous(), "lengths must be contiguous "
           "int32 [B]")
    G = H // KV
    _check(smem_bytes(G, T, hd) <= MAX_SMEM_BYTES,
           f"G={G}, T={T}, hd={hd} need {smem_bytes(G, T, hd)} bytes of "
           "shared memory")
    out = torch.empty_like(q)
    if B == 0 or P == 0:
        return out.zero_()
    scale = 1.0 / math.sqrt(hd) if scale_override is None else \
        scale_override
    lib = _lib()
    err = lib.paged_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, KV, hd, T, page_table.shape[1],
        *k_pages.stride()[:3], *v_pages.stride()[:3], float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
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
        fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i,
                       i64, i64, i64, i64, i64, i64, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib

