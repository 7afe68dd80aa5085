"""Dispatchers the model calls: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to the kernel's plain version.  There is no fallback:
on the card a kernel that cannot launch raises.

Port of ``repro.kernels.ops``.  ``dispatch_counts`` counts calls per
dispatcher on every device (the counterpart of the reference's
``paged_attention_decode_traces``: a rising count shows the model went
through the dispatcher); the kernels' own launch counts live in
``cuda_build.LAUNCHES``.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa

_calls: Dict[str, int] = {"flash_attention": 0, "paged_attention_decode": 0}


def dispatch_counts() -> Dict[str, int]:
    return dict(_calls)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """[B,S,H,hd] x [B,S,KV,hd] -> [B,S,H,hd]."""
    _calls["flash_attention"] += 1
    if q.is_cuda:
        return _fa.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window)
    return _fa.flash_attention_plain(q, k, v, causal=causal, window=window)


def paged_attention_decode(q, k_pages, v_pages, page_table, lengths):
    """Decode-path dispatcher: q [B,H,hd] against (possibly strided)
    page pools [P,T,KV,hd] through ``page_table`` [B,MP] int32."""
    _calls["paged_attention_decode"] += 1
    if q.is_cuda:
        return _pa.paged_attention_cuda(q, k_pages, v_pages, page_table,
                                        lengths)
    return _pa.paged_attention_plain(q, k_pages, v_pages, page_table,
                                     lengths)
