"""Plain torch oracles for the ported kernels (the allclose targets).

The SIMPLEST correct implementations (naive exact softmax, per-token
recurrence), independent of the blocked math of the kernels and of the
model's chunked path — the counterparts of ``repro.kernels.ref``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention_plain


#: the flash kernel's plain version already is the exact-softmax oracle
flash_attention_ref = flash_attention_plain


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive per-token WKV6 recurrence, in f32.

    r,k,v,w [B,S,H,N]; u [H,N]; state [B,H,N,N] -> (out [B,S,H,N], state').
      o_t = r_t (S_{t-1} + diag(u) k_t^T v_t);  S_t = diag(w_t) S_{t-1} + k_t^T v_t
    """
    f32 = torch.float32
    r, k, v, w = (a.to(f32) for a in (r, k, v, w))
    u = u.to(f32)
    s = state.to(f32)
    outs = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhn,bhm->bhnm", k[:, t], v[:, t])
        outs.append(torch.einsum("bhn,bhnm->bhm", r[:, t],
                                 s + u[None, ..., None] * kv))
        s = s * w[:, t, ..., None] + kv
    return torch.stack(outs, dim=1), s


def ssd_ref(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, state: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive per-token SSD recurrence, in f32 (see ``models.ssm``).

    xh [B,S,H,P]; dt [B,S,H]; A [H]; Bm/Cm [B,S,N]; state [B,H,P,N]
    -> (y [B,S,H,P], state').
      h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T;  y_t = h_t C_t
    """
    f32 = torch.float32
    xh, dt, Bm, Cm = (a.to(f32) for a in (xh, dt, Bm, Cm))
    s = state.to(f32)
    ys = []
    for t in range(xh.shape[1]):
        a = torch.exp(dt[:, t] * A[None, :])
        s = s * a[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], xh[:, t], Bm[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", s, Cm[:, t]))
    return torch.stack(ys, dim=1), s


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
