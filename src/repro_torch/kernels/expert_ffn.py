"""Held experts' SwiGLU products over their routed tokens — the CUDA
kernels' wrapper (``csrc/expert_ffn.cu``) and their plain version.

The expert layer of a model whose router picks ``top_k`` of many experts
(``models/moe.routed_apply``) computes, on one chip of an expert-parallel
deployment, only the experts it holds: for every (token, choice) pair
routed to held expert e, ``gate * w_down[e](silu(x w_gate[e]) * x
w_up[e])``, summed per token.  It replaces no Pallas kernel (the JAX
package's expert layer is the capacity dispatch of ``models/moe.py``,
batched over every expert); it exists because that form computes a fixed
capacity of rows per expert, 16 times the useful rows at prefill when a
chip holds 8 of 128 experts, and drops pairs past it.

The wrapper makes two calls: ``expert_sort_kernel`` sorts the pairs on
the card by local expert id (:func:`sort_pairs_cuda`, the contract of
:func:`sort_pairs`, except that an expert's rows may come in any order),
and the products (``expert_gate_up_kernel``, ``expert_down_kernel``,
``expert_combine_kernel``; the source's header says what bounds them and
how they are laid out) take the sorted rows in tiles of ``row_tile(T)``
rows, sized for a few rows an expert at a decode batch and for ~100 at a
prompt.  No host sync, so a CUDA graph captures the call.

:func:`expert_ffn_plain` computes every held expert over every token,
weighted by the token's gate for it (0 where it did not choose it): the
same sums, independent of the sort, for the CPU and the tests.
"""

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda_build

#: ``cuda_build.LAUNCHES`` name of one call (its four kernels)
LAUNCHES = "expert_ffn"


def expert_ffn_plain(x: torch.Tensor, ids: torch.Tensor, gates: torch.Tensor,
                     w_gate: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor) -> torch.Tensor:
    """x [T, D]; ids [T, K] local expert ids (outside ``0..held-1``: not
    held); gates [T, K] f32; w_gate/w_up [held, D, F], w_down [held, F, D]
    -> [T, D] f32, each token's held pairs' gated outputs summed."""
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(w_gate.shape[0]):
        g = torch.sum(gates * (ids == e), dim=-1)               # [T]
        h = F.silu(x @ w_gate[e]) * (x @ w_up[e])
        y = y + g[:, None] * (h @ w_down[e]).float()
    return y


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"expert_ffn: {msg}")




def sort_pairs(ids: torch.Tensor, held: int):
    """The plain version of the kernels' sort (torch's stable sort, so an
    expert's rows in token order): ids [T, K] local expert ids -> the
    kernels' int32 indexes of the
    T K pairs (pair p is token p // K's choice p % K): ``order`` [T K],
    the pair each sorted row holds, held expert 0's pairs first in token
    order, then 1's, ..., the pairs not held last; ``offs`` [held + 1],
    expert e's sorted rows ``offs[e]..offs[e+1]-1``; ``slot`` [T K], the
    sorted row of each pair; ``key`` [T K], each pair's expert, ``held``
    where it is not held."""
    pairs = ids.numel()
    key = torch.where((ids >= 0) & (ids < held), ids,
                      torch.full_like(ids, held)).reshape(pairs)
    sorted_key, order = torch.sort(key, stable=True)
    offs = torch.searchsorted(
        sorted_key, torch.arange(held + 1, dtype=sorted_key.dtype,
                                 device=ids.device)).to(torch.int32)
    slot = torch.empty_like(order)
    slot[order] = torch.arange(pairs, dtype=order.dtype, device=ids.device)
    return (order.to(torch.int32), offs, slot.to(torch.int32),
            key.to(torch.int32))


def sort_pairs_cuda(ids: torch.Tensor, held: int):
    """:func:`sort_pairs` on the card by ``expert_sort_kernel``: the same
    ``offs`` and ``key``, each expert's rows the same pairs in an order the
    kernel's atomics choose, ``slot`` the inverse of ``order``."""
    pairs = ids.numel()
    ids = ids.reshape(pairs).to(torch.int64).contiguous()
    order, slot, key = (torch.empty(pairs, dtype=torch.int32,
                                    device=ids.device) for _ in range(3))
    offs = torch.empty(held + 1, dtype=torch.int32, device=ids.device)
    err = _lib().expert_sort_launch(
        ids.data_ptr(), pairs, held, order.data_ptr(), offs.data_ptr(),
        slot.data_ptr(), key.data_ptr(),
        torch.cuda.current_stream(ids.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"expert_sort kernel launch failed: cudaError "
                           f"{err}")
    return order, offs, slot, key


def row_tile(T: int) -> int:
    """Rows a block of the products takes, for a call of ``T`` tokens:
    16 at a decode batch (an expert sees a few), 128 at a prompt (an
    expert's ~100 rows of a 1,536-token prompt in one tile, so its weights
    are read once).  Widths that are not multiples of 128 take 16 rows
    whatever ``T``."""
    return 16 if T <= 64 else 128


def expert_ffn_cuda(x, ids, gates, w_gate, w_up, w_down) -> torch.Tensor:
    """The kernels; same contract as :func:`expert_ffn_plain`.  bf16 only,
    d_model and d_ff multiples of 64; every tensor on one card, the
    weights contiguous.  Counts one launch per call (its sort, products and
    combine) as ``LAUNCHES``."""
    _check(x.is_cuda, "x must be a CUDA tensor")
    _check(x.dtype == torch.bfloat16 and w_gate.dtype == x.dtype
           and w_up.dtype == x.dtype and w_down.dtype == x.dtype,
           f"dtypes {x.dtype}, {w_gate.dtype}: the kernels take bfloat16")
    _check(all(t.device == x.device for t in (ids, gates, w_gate, w_up,
                                              w_down)),
           "every tensor on x's device")
    T, D = x.shape
    K = ids.shape[1]
    held, _, Fd = w_gate.shape
    _check(ids.shape == (T, K) and gates.shape == (T, K)
           and w_gate.shape == (held, D, Fd) and w_up.shape == w_gate.shape
           and w_down.shape == (held, Fd, D), "shapes")
    _check(D % 64 == 0 and Fd % 64 == 0,
           f"d_model {D} and d_ff {Fd} must be multiples of 64")
    _check(all(t.is_contiguous() for t in (w_gate, w_up, w_down)),
           "the weights must be contiguous")
    out = torch.empty((T, D), dtype=torch.float32, device=x.device)
    if T == 0:
        return out
    x = x.contiguous()
    order, offs, slot, key = sort_pairs_cuda(ids, held)
    gflat = gates.reshape(T * K).to(torch.float32).contiguous()

    rows = T * min(K, held)            # the most pairs the chip can hold
    h = torch.empty((rows, Fd), dtype=x.dtype, device=x.device)
    y = torch.empty((rows, D), dtype=torch.float32, device=x.device)
    err = _lib().expert_ffn_launch(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        order.data_ptr(), offs.data_ptr(), gflat.data_ptr(), slot.data_ptr(),
        key.data_ptr(), h.data_ptr(), y.data_ptr(), out.data_ptr(), T, D, Fd,
        K, held, rows, row_tile(T),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"expert_ffn kernel launch failed: cudaError {err}")
    cuda_build.count_launch(LAUNCHES)
    return out


def _lib():
    lib = cuda_build.load("expert_ffn")
    if lib.expert_ffn_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.expert_ffn_launch.argtypes = [p] * 12 + [i] * 7 + [p]
        lib.expert_ffn_launch.restype = ctypes.c_int
        lib.expert_sort_launch.argtypes = [p, i, i, p, p, p, p, p]
        lib.expert_sort_launch.restype = ctypes.c_int
    return lib
