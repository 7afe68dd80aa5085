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

from repro_torch.kernels import expert_ffn as _ef
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mla_decode as _mla
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import rwkv6_scan as _rw

_calls: Dict[str, int] = {"flash_attention": 0, "paged_attention_decode": 0,
                          "rwkv6_scan": 0, "ssd_scan": 0, "expert_ffn": 0,
                          "mla_decode": 0}


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
                    window: Optional[int] = None,
                    scale: Optional[float] = None):
    """[B,S,H,hd] x [B,S,KV,hd] x [B,S,KV,hdv] -> [B,S,H,hdv]; ``scale``
    1 / sqrt(hd) if None."""
    _calls["flash_attention"] += 1
    if q.is_cuda:
        refuse_autograd("flash_attention", "flash_attention_plain", q, k, v)
        return _fa.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, scale=scale)
    return _fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)


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


def paged_attention_decode(q, k_pages, v_pages, page_table, lengths,
                           window: int = 0):
    """Decode-path dispatcher: q [B,H,hd] against (possibly strided)
    page pools [P,T,KV,hd] through ``page_table`` [B,MP] int32; ``window``
    > 0 attends each row's last ``window`` keys."""
    _calls["paged_attention_decode"] += 1
    if q.is_cuda:
        refuse_autograd("paged_attention_decode", "paged_attention_plain",
                        q, k_pages, v_pages)
        return _pa.paged_attention_cuda(q, k_pages, v_pages, page_table,
                                        lengths, window=window)
    return _pa.paged_attention_plain(q, k_pages, v_pages, page_table,
                                     lengths, window=window)


def mla_decode(q, pages, page_table, lengths, *, scale: float,
               v_width: int):
    """Latent attention's absorbed decode: q [B,H,Dk] against one layer's
    (possibly strided) latent pages [P,T,Dk] through ``page_table``
    [B,MP] int32, over ``lengths`` rows; v is each row's first
    ``v_width`` columns -> [B,H,v_width]."""
    _calls["mla_decode"] += 1
    if q.is_cuda:
        refuse_autograd("mla_decode", "mla_decode_plain", q, pages)
        return _mla.mla_decode_cuda(q, pages, page_table, lengths,
                                    scale=scale, v_width=v_width)
    return _mla.mla_decode_plain(q, pages, page_table, lengths, scale=scale,
                                 v_width=v_width)


def expert_ffn(x, ids, gates, w_gate, w_up, w_down):
    """Held experts' gated SwiGLU outputs per token: x [T, D], ids and
    gates [T, K] (ids local to the held experts), w_gate/w_up [held, D,
    F], w_down [held, F, D] -> [T, D] f32."""
    _calls["expert_ffn"] += 1
    if x.is_cuda:
        refuse_autograd("expert_ffn", "expert_ffn_plain", x, w_gate, w_up,
                        w_down)
        return _ef.expert_ffn_cuda(x, ids, gates, w_gate, w_up, w_down)
    return _ef.expert_ffn_plain(x, ids, gates, w_gate, w_up, w_down)
