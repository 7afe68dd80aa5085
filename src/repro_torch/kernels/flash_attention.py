"""Flash attention forward — CUDA kernels, their plain version, a wrapper.

Port of ``repro.kernels.flash_attention``.  The kernels
(``csrc/flash_attention.cu``) replace the Pallas TPU kernel
``flash_attention``: blocked online-softmax attention, causal with an
optional sliding window, GQA head h reading kv head ``h // G``.  The dtype
picks the kernel.  bf16 runs on tensor cores (``mma.sync`` m16n8k16, one
block per 32-row q tile, head and batch, whose two warp pairs take every
other K tile and merge at the end; K/V tiles streamed by ``cp.async``
into two-stage rings; online softmax in registers).  f32 keeps the
CUDA-core kernel, since tensor cores would mean TF32.  Both loops over K
tiles start at the window's edge and stop at the causal edge, the
counterpart of the TPU kernel's ``pl.when`` skip of fully masked blocks.

:func:`flash_attention_plain` is exact softmax, like
``flash_attention_ref``; the CPU path and the tests use it, and
``chip_smoke.py`` holds the kernels against it on the card.

v may be narrower than q and k where one bf16 instantiation takes it:
q/k 192 and v 128 wide (``SPLIT_WIDTHS``), latent attention's expanded
prefill (``models/mla.py``), with the caller's softmax ``scale`` (1 /
sqrt(hd) by default).  Each call counts one launch as
``flash_attention``, and a split-width call once more as
``SPLIT_WIDTH_LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (q/k width, v width) of the one bf16 instantiation whose widths differ
SPLIT_WIDTHS = (192, 128)
#: ``cuda_build.LAUNCHES`` name of its calls
SPLIT_WIDTH_LAUNCHES = "flash_attention.split_width"


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None):
    """q [B,S,H,hd]; k [B,S,KV,hd]; v [B,S,KV,hdv] -> [B,S,H,hdv].  Exact
    softmax in f32, scaled by ``scale`` (1 / sqrt(hd) if None)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, kf) * (
        1.0 / math.sqrt(hd) if scale is None else scale)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, vf)
    return o.reshape(B, S, H, v.shape[3]).to(q.dtype)


def _check(cond: bool, msg) -> None:
    """Raise unless ``cond``; ``msg`` is a string or, where it needs
    formatting, a function that makes it (called only on failure: the
    wrappers are on the serve path's host time)."""
    if not cond:
        raise ValueError(f"flash_attention: {msg() if callable(msg) else msg}")


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None):
    """Launch the CUDA kernel; same contract as the plain version.
    Raises on anything the kernel does not take, such as bf16 tensors that
    do not start on a 16-byte boundary (the bf16 kernel reads 16-byte
    vectors), or widths of q and v that no instantiation pairs."""
    _check(q.is_cuda, "q must be a CUDA tensor")
    _check(k.device == q.device and v.device == q.device,
           "q, k and v must be on one device")
    _check(q.dtype in _DTYPES,
           lambda: f"dtype {q.dtype} (float32 or bfloat16)")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           "q, k and v must share a dtype")
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4
           and k.shape[:3] == v.shape[:3],
           "q must be [B,S,H,hd], k [B,S,KV,hd] and v [B,S,KV,hdv]")
    B, S, H, hd = q.shape
    hdv = v.shape[3]
    _check(tuple(k.shape[:2]) == (B, S) and k.shape[3] == hd,
           lambda: f"k/v shape {tuple(k.shape)} does not match q "
           f"{tuple(q.shape)}")
    _check(hdv == hd or ((hd, hdv) == SPLIT_WIDTHS
                         and q.dtype == torch.bfloat16),
           lambda: f"q/k width {hd} and v width {hdv} (equal, or bf16 at "
           f"{SPLIT_WIDTHS})")
    KV = k.shape[2]
    _check(KV > 0 and H % KV == 0, lambda: f"{H} heads over {KV} kv heads")
    _check(cuda_build.head_dim_ok(hd),
           lambda: f"head_dim {hd} ({cuda_build.HEAD_DIM_RULE})")
    _check(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
           "q, k and v must be contiguous")
    _check(window is None or window > 0,
           lambda: f"window {window} must be > 0")
    _check(q.dtype != torch.bfloat16 or all(
        t.data_ptr() % 16 == 0 for t in (q, k, v)),
        "bf16 q, k and v must start on 16-byte boundaries")
    out = q.new_empty((B, S, H, hdv))
    if out.numel() == 0:
        return out
    lib = _lib()
    err = lib.flash_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, S, H, KV, hd, hdv, int(causal),
        0 if window is None else int(window),
        1.0 / math.sqrt(hd) if scale is None else float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    cuda_build.count_launch("flash_attention")
    if hdv != hd:
        cuda_build.count_launch(SPLIT_WIDTH_LAUNCHES)
    return out


def _lib():
    lib = cuda_build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib

