"""Flash attention forward — the CUDA kernel, its plain version, a wrapper.

Port of ``repro.kernels.flash_attention``.  The kernel
(``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``flash_attention``: blocked online-softmax attention, causal with an
optional sliding window, GQA head h reading kv head ``h // G``.  One block
per (batch, head, 32-row q tile); its loop over K tiles starts at the
window's edge and stops at the causal edge, the counterpart of the TPU
kernel's ``pl.when`` skip of fully masked blocks.

:func:`flash_attention_plain` is exact softmax, like
``flash_attention_ref``; the CPU path and the tests use it, and
``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import cuda_build

BLOCK_Q = 32
BLOCK_K = 32
MAX_SMEM_BYTES = 232448
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None):
    """q [B,S,H,hd]; k,v [B,S,KV,hd] -> [B,S,H,hd].  Exact softmax in f32."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, kf) / math.sqrt(hd)
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
    return o.reshape(B, S, H, hd).to(q.dtype)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def smem_bytes(hd: int) -> int:
    """Dynamic shared memory one block of the kernel takes."""
    return 4 * (BLOCK_Q * hd + BLOCK_K * (hd + 1) + BLOCK_K * hd
                + BLOCK_Q * hd + BLOCK_Q * BLOCK_K + 3 * BLOCK_Q)


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None):
    """Launch the CUDA kernel; same contract as the plain version.
    Raises on anything the kernel does not take."""
    _check(q.is_cuda, "q must be a CUDA tensor")
    _check(k.device == q.device and v.device == q.device,
           "q, k and v must be on one device")
    _check(q.dtype in _DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           "q, k and v must share a dtype")
    _check(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
           "q must be [B,S,H,hd] and k, v [B,S,KV,hd]")
    B, S, H, hd = q.shape
    _check(tuple(k.shape[:2]) == (B, S) and k.shape[3] == hd,
           f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    KV = k.shape[2]
    _check(KV > 0 and H % KV == 0, f"{H} heads over {KV} kv heads")
    _check(hd % 16 == 0 and 16 <= hd <= 256, f"head_dim {hd} (16..256, "
           "a multiple of 16)")
    _check(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
           "q, k and v must be contiguous")
    _check(window is None or window > 0, f"window {window} must be > 0")
    _check(smem_bytes(hd) <= MAX_SMEM_BYTES, f"head_dim {hd} needs "
           f"{smem_bytes(hd)} bytes of shared memory")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    err = lib.flash_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, S, H, KV, hd, int(causal),
        0 if window is None else int(window), 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    cuda_build.count_launch("flash_attention")
    return out


def _lib():
    lib = cuda_build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float,
                       p]
        fn.restype = ctypes.c_int
    return lib

