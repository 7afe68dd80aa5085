"""Dispatchers the model calls: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to the kernel's plain version.  There is no fallback:
on the card a kernel that cannot launch raises.  ``ssd_scan`` has no
kernel, as in the reference: it runs the chunked torch form everywhere.

Port of ``repro.kernels.ops``.  ``dispatch_counts`` counts calls per
dispatcher on every device (the counterpart of the reference's
``paged_attention_decode_traces``: a rising count shows the model went
through the dispatcher); the kernels' own launch counts live in
``cuda_build.LAUNCHES``.

The hand-written kernels have no backward, as the Pallas kernels define no
VJP: on the card a dispatcher refuses a call that autograd would have to
differentiate (:func:`refuse_autograd`) instead of dropping the gradient.
Training runs the plain versions, as the reference's does
(``Flags(use_kernels=False)``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import rwkv6_scan as _rw

_calls: Dict[str, int] = {"flash_attention": 0, "paged_attention_decode": 0,
                          "rwkv6_scan": 0, "ssd_scan": 0}


def dispatch_counts() -> Dict[str, int]:
    return dict(_calls)


def add_dispatches(counts: Dict[str, int]) -> None:
    """Add a CUDA graph's dispatcher calls per replay, or, negated, take
    back its capture's (``cuda_build.add_launches`` for the kernels)."""
    for name, n in counts.items():
        _calls[name] += n


def refuse_autograd(name: str, plain: str, *tensors) -> None:
    """Raise if grad mode is on and any of ``tensors`` requires grad: the
    CUDA kernel ``name`` has no backward."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward pass, so autograd "
            f"cannot differentiate through it; train with "
            f"Flags(use_kernels=False), which runs its plain version "
            f"{plain} (the reference's training path), or call it under "
            f"torch.no_grad()")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """[B,S,H,hd] x [B,S,KV,hd] -> [B,S,H,hd]."""
    _calls["flash_attention"] += 1
    if q.is_cuda:
        refuse_autograd("flash_attention", "flash_attention_plain", q, k, v)
        return _fa.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window)
    return _fa.flash_attention_plain(q, k, v, causal=causal, window=window)


def rwkv6_scan(r, k, v, w, u, state, chunk: int = 64):
    """r,k,v,w [B,S,H,N]; u [H,N]; state [B,H,N,N] -> (out, state'), both
    f32.  ``chunk`` is the plain version's; the kernel takes any S as it
    is."""
    _calls["rwkv6_scan"] += 1
    if r.is_cuda:
        refuse_autograd("rwkv6_scan", "rwkv6_scan_plain", r, k, v, w, u,
                        state)
        return _rw.rwkv6_scan_cuda(r, k, v, w, u, state)
    return _rw.rwkv6_scan_plain(r, k, v, w, u, state, chunk=chunk)


def ssd_scan(xh, dt, A, Bm, Cm, state):
    """SSD prefill scan: xh [B,S,H,P]; dt [B,S,H]; A [H]; Bm/Cm [B,S,N];
    state [B,H,P,N] -> (y, state'), f32.  The reference has no Pallas
    kernel here (its ``ops.ssd_scan`` runs the chunked XLA form), so on
    every device this is the port's chunked form, chunk 64."""
    from repro_torch.models.ssm import ssd_chunked
    _calls["ssd_scan"] += 1
    return ssd_chunked(xh, dt, A, Bm, Cm, state)


def paged_attention_decode(q, k_pages, v_pages, page_table, lengths):
    """Decode-path dispatcher: q [B,H,hd] against (possibly strided)
    page pools [P,T,KV,hd] through ``page_table`` [B,MP] int32."""
    _calls["paged_attention_decode"] += 1
    if q.is_cuda:
        refuse_autograd("paged_attention_decode", "paged_attention_plain",
                        q, k_pages, v_pages)
        return _pa.paged_attention_cuda(q, k_pages, v_pages, page_table,
                                        lengths)
    return _pa.paged_attention_plain(q, k_pages, v_pages, page_table,
                                     lengths)
