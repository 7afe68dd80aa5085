"""RWKV-6 WKV scan — the CUDA kernel, its plain version, a wrapper.

Port of ``repro.kernels.rwkv6_scan``.  The kernel (``csrc/rwkv6_scan.cu``)
replaces the Pallas TPU kernel ``rwkv6_scan`` (body ``_wkv_kernel``), which
walks chunks of 64 tokens on a sequential grid axis and carries the f32
``[N, N]`` state in VMEM from one chunk to the next:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

What bounds it on the card: at the full-width prefill (B=1, S=256, H=64,
N=64) the scan moves 16.8 MB (bf16 r, k, v; f32 w, out, state), 0.00501
ms at 3.35 TB/s, and does 5 N^2 + 4 N f32 operations per token and head,
0.00507 ms at the 67 TFLOP/s of CUDA cores: the bounds meet.  The first
port walked the tokens one by one per block and was bound by latency, at
17x the bound.  The kernel is the chunked form on tensor cores: one block
per (b, h, group of value columns), :func:`scan_plan` choosing the groups
from B * H and the SM count; the block walks 64-token chunks in order with
the group's state columns in shared memory, and inside a chunk
(sub-chunks of 16 tokens) the read-out of the state, the off-diagonal
score blocks, scores times v and the carry are ``mma.sync`` TF32 products
with each f32 operand split into two TF32 halves (three MMAs per product,
two against bf16 v, which is exact in TF32), as exact as f32 for the 2e-4
check.  Only the 8x8 triangles on the scores' diagonal run on CUDA cores.
Decays are running products of w over exactly their own tokens, never
differences of prefix sums.  The next chunk is staged by ``cp.async``
while this one computes.

:func:`rwkv6_scan_plain` is the TPU kernel's chunked math step for step in
f32 (the same computation as the reference's ``wkv_chunked``); a ragged
last chunk is padded with neutral tokens (``r = k = v = 0``, ``w = 1``)
whose rows are dropped, so any S works.  The CPU path and the tests use
it, and ``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import cuda_build

#: the floor of w before its log.  The TPU kernel clamps at 1e-38, a
#: subnormal that a unit flushing subnormals to zero (XLA on the CPU, the
#: TPU) turns into 0, so log(w) = -inf and the scan returns NaN where w
#: holds a zero; the smallest normal float is what that clamp means.
W_MIN = torch.finfo(torch.float32).tiny
#: head sizes the kernel is built for
HEAD_DIMS = (16, 32, 64)
#: value columns a block takes at the least (two 8-column mma tiles)
MIN_COLS = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _pad_tail(a: torch.Tensor, pad: int, value: float) -> torch.Tensor:
    """a [B, S, H, N] -> [B, S + pad, H, N], the new rows set to value."""
    if pad == 0:
        return a
    fill = a.new_full((a.shape[0], pad, *a.shape[2:]), value)
    return torch.cat([a, fill], dim=1)


def _shift(a: torch.Tensor, first: bool) -> torch.Tensor:
    """Shift along the token axis by one, a zero row entering first (at
    the start) or last (at the end): exclusive scans without subtracting
    one large sum from another."""
    zero = torch.zeros_like(a[:, :1])
    return (torch.cat([zero, a[:, :-1]], dim=1) if first
            else torch.cat([a[:, 1:], zero], dim=1))


def rwkv6_scan_plain(r, k, v, w, u, state, chunk: int = 64
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,w [B,S,H,N]; u [H,N]; state [B,H,N,N] -> (out [B,S,H,N],
    state' [B,H,N,N]), both f32.  Chunked: within a chunk of T tokens the
    pairwise decay keeps every exponent <= 0; the state carries across
    chunks.

    Every log-decay exponent is summed over exactly its own tokens (the
    pairwise ones by a masked cumulative sum, the carry's by a suffix
    sum) rather than taken as the difference of two prefix sums, as the
    TPU kernel takes it: a zero in w adds about -87 to a prefix sum, and
    the difference of two such sums keeps only a few bits of a decay that
    should be exp(0)."""
    B, S, H, N = r.shape
    T = min(chunk, S)
    pad = -S % T
    f32 = torch.float32
    r, k, v = (_pad_tail(a.to(f32), pad, 0.0) for a in (r, k, v))
    logw = _pad_tail(torch.log(torch.clamp(w.to(f32), min=W_MIN)), pad, 0.0)
    u = u.to(f32)
    state = state.to(f32)
    nc = (S + pad) // T
    ones = torch.ones((T, T), dtype=torch.bool, device=r.device)
    after = torch.triu(ones, diagonal=1)[None, :, :, None, None]   # [s, j]
    before = torch.tril(ones, diagonal=-1)[None, :, :, None, None]  # [t, s]
    outs = []
    for c in range(nc):
        sl = slice(c * T, (c + 1) * T)
        rt, kt, vt, lwt = r[:, sl], k[:, sl], v[:, sl], logw[:, sl]
        cum = torch.cumsum(lwt, dim=1)                  # sum_{j<=t}, [B,T,H,N]
        # inter-chunk: o_t += (r_t * prod_{j<t} w_j) @ state
        inter = torch.einsum("bthn,bhnm->bthm",
                             rt * torch.exp(_shift(cum, first=True)), state)
        # intra-chunk pairs s < t: decay prod_{s<j<t} w_j, summed from 0 at
        # each s (seg[s, t] = sum_{s<j<t} lw_j), every exponent <= 0
        seg = torch.cumsum(lwt[:, None].masked_fill(~after, 0.0), dim=2)
        seg = _shift(seg.transpose(1, 2), first=True)           # [B,T,T,H,N]
        decay = torch.exp(seg.masked_fill(~before, float("-inf")))
        scores = torch.einsum("bthn,bshn,btshn->bhts", rt, kt, decay)
        intra = torch.einsum("bhts,bshm->bthm", scores, vt)
        # the current token's bonus u
        bonus = torch.einsum("bthn,bthn,bthm->bthm", rt, u[None, None] * kt,
                             vt)
        outs.append(inter + intra + bonus)
        # carry: S' = diag(prod chunk) S + sum_s (prod_{j>s} w_j) k_s^T v_s
        suffix = _shift(torch.flip(torch.cumsum(torch.flip(lwt, [1]), 1),
                                   [1]), first=False)           # sum_{j>s}
        state = state * torch.exp(cum[:, -1])[..., None] + \
            torch.einsum("bshn,bshm->bhnm", kt * torch.exp(suffix), vt)
    out = torch.cat(outs, dim=1)[:, :S]
    return out, state


def scan_plan(B: int, H: int, N: int,
              sm_count: int = cuda_build.H100_SXM_SMS) -> int:
    """Value-column groups per head, one block each: the most (a power of
    two, at most ``N // MIN_COLS``) that keep the ``B * H * groups``
    blocks within one wave of one block per SM.  Each group repeats the
    chunk's scores, which do not depend on the columns, so more groups
    than SMs only add work.  Reads shapes and the card, never the data."""
    groups = 1
    while groups * 2 * MIN_COLS <= N and B * H * groups * 2 <= sm_count:
        groups *= 2
    return groups


def _check(cond: bool, msg) -> None:
    """Raise unless ``cond``; ``msg`` is a string or, where it needs
    formatting, a function that makes it (called only on failure: the
    wrapper is on the prefill path's host time)."""
    if not cond:
        raise ValueError(f"rwkv6_scan: {msg() if callable(msg) else msg}")


def rwkv6_scan_cuda(r, k, v, w, u, state
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; same contract as the plain version (the
    kernel needs no chunk).  Raises on anything the kernel does not take."""
    _check(r.is_cuda, "r must be a CUDA tensor")
    dev = r.device
    _check(k.device == dev and v.device == dev and w.device == dev
           and u.device == dev and state.device == dev,
           "all inputs must be on one device")
    _check(r.dtype in _DTYPES,
           lambda: f"dtype {r.dtype} (float32 or bfloat16)")
    _check(k.dtype == r.dtype and v.dtype == r.dtype,
           "r, k and v must share a dtype")
    _check(w.dtype == u.dtype == state.dtype == torch.float32,
           "w, u and state must be float32")
    _check(r.dim() == 4, "r must be [B,S,H,N]")
    B, S, H, N = r.shape
    _check(k.shape == r.shape and v.shape == r.shape and w.shape == r.shape,
           "r, k, v and w must share their shape")
    _check(u.shape == (H, N),
           lambda: f"u shape {tuple(u.shape)} != {(H, N)}")
    _check(state.shape == (B, H, N, N),
           lambda: f"state shape {tuple(state.shape)} != {(B, H, N, N)}")
    _check(N in HEAD_DIMS, lambda: f"head size {N} (one of {HEAD_DIMS})")
    _check(S >= 1, "S must be >= 1")
    _check(r.is_contiguous() and k.is_contiguous() and v.is_contiguous()
           and w.is_contiguous() and u.is_contiguous()
           and state.is_contiguous(), "all inputs must be contiguous")
    _check((r.data_ptr() | k.data_ptr() | v.data_ptr() | w.data_ptr())
           % 16 == 0, "r, k, v and w must start on 16-byte boundaries")
    out = torch.empty((B, S, H, N), dtype=torch.float32, device=dev)
    state_out = torch.empty_like(state)
    if B * H == 0:
        return out, state_out
    err = _lib().rwkv6_scan_launch(
        _DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
        w.data_ptr(), u.data_ptr(), state.data_ptr(), out.data_ptr(),
        state_out.data_ptr(), B, S, H, N,
        scan_plan(B, H, N, cuda_build.sm_count(dev)),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: cudaError "
                           f"{err}")
    cuda_build.count_launch("rwkv6_scan")
    return out, state_out


def shared_bytes(dtype: torch.dtype, N: int, groups: int) -> int:
    """Dynamic shared memory of one block of the kernel built for r/k/v of
    ``dtype``, head size N and ``groups`` column groups (builds it)."""
    return _lib().rwkv6_scan_smem_bytes(_DTYPES[dtype], N, groups)


def _lib():
    lib = cuda_build.load("rwkv6_scan")
    fn = lib.rwkv6_scan_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.rwkv6_scan_smem_bytes.argtypes = [i, i, i]
        lib.rwkv6_scan_smem_bytes.restype = i
    return lib
