"""Plain torch oracles for the ported kernels (the allclose targets).

The SIMPLEST correct implementations (naive exact softmax), independent of
the blocked math of the kernels and of the model's chunked path — the
counterparts of ``repro.kernels.ref``.
"""

from __future__ import annotations

import math
import torch

from repro_torch.kernels.flash_attention import flash_attention_plain


#: the flash kernel's plain version already is the exact-softmax oracle
flash_attention_ref = flash_attention_plain


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention through a page table (the L2P-lookup analogue).

    q [B,H,hd]; k_pages/v_pages [P, T, KV, hd]; page_table [B, MP] int32
    (-1 = unmapped); lengths [B] valid token count -> out [B,H,hd].
    """
    B, H, hd = q.shape
    P, T, KV, _ = k_pages.shape
    MP = page_table.shape[1]
    G = H // KV
    safe = page_table.clamp(min=0).long()
    k = k_pages[safe].reshape(B, MP * T, KV, hd).float()
    v = v_pages[safe].reshape(B, MP * T, KV, hd).float()
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k) / math.sqrt(hd)
    pos = torch.arange(MP * T, device=q.device)[None]
    valid = (pos < lengths[:, None]) & \
        torch.repeat_interleave(page_table >= 0, T, dim=1)
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)
    o = torch.einsum("bkgs,bskh->bkgh", p, v)
    return o.reshape(B, H, hd).to(q.dtype)
