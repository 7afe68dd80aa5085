"""Selective SSM (Mamba-2/SSD style), the SSM branch of hymba blocks
(port of ``repro.models.ssm``).

Per head h (P = head channel dim, N = ssm_state):

    h_t = exp(dt_t * A_h) h_{t-1} + dt_t * (x_t ⊗ B_t)     h in R^{P x N}
    y_t = h_t C_t + D_h x_t

with dt_t data-dependent (softplus), A_h < 0 learned scalars per head, and
B_t, C_t in R^N input-dependent.  Prefill runs the chunked parallel form
(:func:`ssd_chunked`, float32 math), decode one state update
(:func:`ssd_step`).  The reference's chunked form asserts that a prompt
longer than a chunk is a whole number of chunks; the port pads a ragged
last chunk with neutral tokens instead (x = 0, dt = 0, B = C = 0: decay 1,
no update), so any length prefills.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.flags import DEFAULT_FLAGS, Flags
from repro_torch.models.layers import (Params, dense, dense_init, dtype_of,
                                       randn_init)

CONV_K = 4  # depthwise causal conv kernel width


def ssm_dims(cfg) -> Tuple[int, int, int]:
    """(d_in, H, P): inner width, SSM heads and channels per head."""
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads or max(1, d_in // 64)
    return d_in, H, d_in // H


def ssm_init(gen: torch.Generator, cfg, n: Optional[int] = None) -> Params:
    """One layer's params (``n`` stacks ``n`` layers on a leading axis);
    ``A_log`` and ``D_skip`` stay float32, as in the reference."""
    dt_ = dtype_of(cfg)
    D, N = cfg.d_model, cfg.ssm_state
    d_in, H, _ = ssm_dims(cfg)
    lead = () if n is None else (n,)
    dev = gen.device
    return {
        "in_proj": dense_init(gen, D, 2 * d_in, dt_, n=n),   # [x, gate z]
        "conv_w": randn_init(gen, (*lead, CONV_K, d_in), 0.2, dt_),
        "conv_b": torch.zeros((*lead, d_in), dtype=dt_, device=dev),
        "bc_proj": dense_init(gen, d_in, 2 * N, dt_, n=n),   # B_t, C_t
        "dt_proj": dense_init(gen, d_in, H, dt_, bias=True, n=n),
        "A_log": torch.zeros((*lead, H), dtype=torch.float32, device=dev),
        "D_skip": torch.ones((*lead, H), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, d_in, D, dt_, n=n),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: torch.Tensor) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Depthwise causal conv.  x [B,S,C]; w [K,C]; init_state [B,K-1,C].

    Returns (y [B,S,C], new_state [B,K-1,C])."""
    K = w.shape[0]
    S = x.shape[1]
    xp = torch.cat([init_state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + S] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else init_state
    return F.silu(y + b), new_state


def ssd_chunked(xh, dt, A, Bm, Cm, state, chunk: int = 64):
    """Chunked SSD scan.

    xh [B,S,H,P] head inputs; dt [B,S,H]; A [H]; Bm/Cm [B,S,N];
    state [B,H,P,N].  Returns (y [B,S,H,P], final state), float32.  A
    ragged last chunk is padded with neutral tokens (decay 1, no update)
    and the padding's outputs are cut off.
    """
    S = xh.shape[1]
    T = min(chunk, S)
    nc = -(-S // T)
    f32 = torch.float32
    xh, dt, Bm, Cm = (a.to(f32) for a in (xh, dt, Bm, Cm))
    if nc * T != S:
        pad = nc * T - S
        xh, dt, Bm, Cm = (F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
                          for a in (xh, dt, Bm, Cm))
    loga = dt * A[None, None, :]                           # [B,S,H]  (<= 0)
    tri = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                device=xh.device))[None, ..., None]
    state = state.to(f32)
    ys = []
    for i in range(nc):
        sl = slice(i * T, (i + 1) * T)
        xc, dtc, lac, Bc, Cc = xh[:, sl], dt[:, sl], loga[:, sl], \
            Bm[:, sl], Cm[:, sl]
        cum = torch.cumsum(lac, dim=1)                     # [B,T,H] inclusive
        # inter-chunk: the carried state reaches y_t decayed by exp(cum_t)
        inter = torch.einsum("bhpn,btn->bthp", state, Cc) * \
            torch.exp(cum)[..., None]
        # intra-chunk: s <= t, decay exp(cum_t - cum_s), weight dt_s
        diff = cum[:, :, None] - cum[:, None, :]           # [B,T,T,H]
        L = torch.exp(torch.where(tri, diff, -torch.inf))
        scores = torch.einsum("btn,bsn,btsh,bsh->bhts", Cc, Bc, L, dtc)
        intra = torch.einsum("bhts,bshp->bthp", scores, xc)
        ys.append(inter + intra)
        # state carry:
        #   h' = exp(total) h + sum_s exp(total - cum_s) dt_s x_s B_s
        total = cum[:, -1]                                 # [B,H]
        w_carry = torch.exp(total[:, None] - cum) * dtc    # [B,T,H]
        state = state * torch.exp(total)[..., None, None] + \
            torch.einsum("bth,bthp,btn->bhpn", w_carry, xc, Bc)
    y = torch.cat(ys, dim=1) if nc > 1 else ys[0]
    return y[:, :S], state


def ssd_step(xh, dt, A, Bm, Cm, state):
    """One decode step.  xh [B,H,P]; dt [B,H]; Bm/Cm [B,N]; state [B,H,P,N]."""
    f32 = torch.float32
    xh, dt, Bm, Cm = (a.to(f32) for a in (xh, dt, Bm, Cm))
    a = torch.exp(dt * A[None, :])                         # [B,H]
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, xh, Bm)
    state = state * a[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, Cm)
    return y, state


def ssm_apply(p: Params, cfg, x: torch.Tensor, conv_state: torch.Tensor,
              ssm_state: torch.Tensor, flags: Flags = DEFAULT_FLAGS,
              decode: bool = False):
    """x [B,S,D]; conv_state [B,K-1,d_in]; ssm_state [B,H,P,N].

    Returns (y [B,S,D], conv_state', ssm_state')."""
    B, S, D = x.shape
    d_in, H, P = ssm_dims(cfg)

    xc, z = torch.chunk(dense(p["in_proj"], x), 2, dim=-1)
    xc, conv_state = _causal_conv(xc, p["conv_w"], p["conv_b"], conv_state)
    Bm, Cm = torch.chunk(dense(p["bc_proj"], xc), 2, dim=-1)  # [B,S,N] each
    dt = F.softplus(dense(p["dt_proj"], xc).float())
    A = -torch.exp(p["A_log"])
    xh = xc.reshape(B, S, H, P)

    if decode:
        y, ssm_state = ssd_step(xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                                ssm_state)
        y = y[:, None]
    elif flags.use_kernels:
        y, ssm_state = kops.ssd_scan(xh, dt, A, Bm, Cm, ssm_state)
    else:
        y, ssm_state = ssd_chunked(xh, dt, A, Bm, Cm, ssm_state,
                                   chunk=flags.scan_chunk)
    y = y + xh.float() * p["D_skip"][None, None, :, None]
    y = y.reshape(B, S, d_in).to(x.dtype) * F.silu(z)
    return dense(p["out_proj"], y), conv_state, ssm_state


def ssm_state_init(cfg, batch: int, device, dtype=torch.float32):
    """(conv_state [B,K-1,d_in] in ``dtype``, ssm_state [B,H,P,N] f32)."""
    d_in, H, P = ssm_dims(cfg)
    return (torch.zeros((batch, CONV_K - 1, d_in), dtype=dtype,
                        device=device),
            torch.zeros((batch, H, P, cfg.ssm_state), dtype=torch.float32,
                        device=device))
