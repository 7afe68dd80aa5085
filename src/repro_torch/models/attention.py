"""GQA attention: prefill (chunked or flash kernel) and decode paths.

Port of ``repro.models.attention``.  Layouts, as in the reference:
  x        [B, S, D]
  q        [B, S, H, hd]        (H = num_heads)
  k, v     [B, S, KV, hd]       (KV = num_kv_heads; GQA groups G = H/KV)
  caches   [B, S_max, KV, hd]   (linear) or [B, W, KV, hd] (SWA ring)

The op order mirrors the reference exactly: scores accumulate in f32 with
the scale applied after the contraction, masking uses -1e30, the softmax
runs in f32, and the probabilities are cast to V's dtype before the second
contraction.  Where the reference returned updated caches or pools, the
port writes them **in place** (noted at each site) and returns them too.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models.flags import DEFAULT_FLAGS, Flags
from repro_torch.models.layers import (Params, apply_rope, dense,
                                       dense_init, dtype_of, rope_angles)

NEG_INF = -1e30


def attention_init(gen: torch.Generator, cfg,
                   n: Optional[int] = None) -> Params:
    dt = dtype_of(cfg)
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    return {
        "wq": dense_init(gen, D, H * hd, dt, bias=cfg.qkv_bias, n=n),
        "wk": dense_init(gen, D, KV * hd, dt, bias=cfg.qkv_bias, n=n),
        "wv": dense_init(gen, D, KV * hd, dt, bias=cfg.qkv_bias, n=n),
        "wo": dense_init(gen, H * hd, D, dt, n=n),
    }


def _head_rms_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-head qk-norm (chameleon), no learned scale."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype)


def _qkv(p: Params, cfg, x: torch.Tensor,
         positions: Optional[torch.Tensor],
         rope: bool = True) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q = dense(p["wq"], x).reshape(B, S, H, hd)
    k = dense(p["wk"], x).reshape(B, S, KV, hd)
    v = dense(p["wv"], x).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q, k = _head_rms_norm(q), _head_rms_norm(k)
    if rope and positions is not None:
        sin, cos = rope_angles(positions, hd, cfg.rope_theta)
        q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
    return q, k, v


def _scores_softmax_out(q, k, v, mask, scale) -> torch.Tensor:
    """q [B,c,KV,G,hd]; k/v [B,Sk,KV,hd]; mask [B,c,Sk] -> [B,c,KV,G,hd]."""
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    s = s.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor,
                      *, causal: bool,
                      window: Optional[int] = None,
                      flags: Flags = DEFAULT_FLAGS) -> torch.Tensor:
    """q [B,Sq,H,hd]; k,v [B,Sk,KV,hd]; positions [B,S*] -> [B,Sq,H,hd]."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    cq = min(flags.attn_chunk, Sq)
    n = -(-Sq // cq)
    qg = q.reshape(B, Sq, KV, G, hd)

    outs = []
    for i in range(n):
        lo, hi = i * cq, min((i + 1) * cq, Sq)
        qc = qg[:, lo:hi]
        qp = q_pos[:, lo:hi]
        k_lo, k_hi = 0, Sk
        if flags.causal_skip and causal and Sq == Sk:
            # static causal truncation: this q-chunk can only see k <= hi-1
            k_hi = hi
            if window is not None:
                k_lo = max(0, lo - window)
        kc, vc = k[:, k_lo:k_hi], v[:, k_lo:k_hi]
        kp = k_pos[:, k_lo:k_hi]
        mask = torch.ones((B, hi - lo, k_hi - k_lo), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kp[:, None, :] <= qp[:, :, None]
        if window is not None:
            mask &= kp[:, None, :] > (qp[:, :, None] - window)
        outs.append(_scores_softmax_out(qc, kc, vc, mask, scale))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out.reshape(B, Sq, H, hd)


# --------------------------------------------------------------- public ops
def attn_forward(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
                 *, causal: bool = True, flags: Flags = DEFAULT_FLAGS,
                 return_kv: bool = False):
    """Prefill attention.  Returns (out, (k, v) if return_kv)."""
    q, k, v = _qkv(p, cfg, x, positions)
    if flags.use_kernels and causal:
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(q, k, v, window=cfg.sliding_window)
    else:
        out = chunked_attention(q, k, v, positions, positions,
                                causal=causal,
                                window=cfg.sliding_window if causal else None,
                                flags=flags)
    B, S = x.shape[:2]
    y = dense(p["wo"], out.reshape(B, S, -1))
    if return_kv:
        return y, (k, v)
    return y


def attn_decode(p: Params, cfg, x: torch.Tensor,
                cache_k: torch.Tensor, cache_v: torch.Tensor,
                cache_pos: torch.Tensor, step: torch.Tensor,
                flags: Flags = DEFAULT_FLAGS):
    """One-token decode against a (linear or ring) KV cache.

    x          [B, 1, D]
    cache_k/v  [B, C, KV, hd]  (C = S_max, or window size for SWA ring)
    cache_pos  [B, C] int32    absolute position stored in each slot (-1 empty)
    step       []    int32     absolute position of the new token

    ``step`` is read on the device only (positions, the ring slot and the
    mask are tensors), so the step can be captured as a CUDA graph.
    Writes the new token's K/V and position into the caches **in place**
    and returns (y, cache_k, cache_v, cache_pos).
    """
    B = x.shape[0]
    C = cache_k.shape[1]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    # a copy, not a broadcast view of ``step``: under FakeTensorMode (the
    # dry run) such a view drops the step's known value, which the dry
    # run's rule for the slot write below reads
    positions = step.reshape(1, 1).repeat(B, 1)
    q, k, v = _qkv(p, cfg, x, positions)

    # ring index (== step for linear caches) as a one-element index: a 0-d
    # tensor used as an index may be read back as a host integer
    slot = torch.remainder(step, C).reshape(1).long()
    cache_k.index_copy_(1, slot, k.to(cache_k.dtype))          # in place
    cache_v.index_copy_(1, slot, v.to(cache_v.dtype))          # in place
    cache_pos.index_copy_(1, slot, positions)                  # in place

    scale = 1.0 / math.sqrt(hd)
    G = H // KV
    qg = q.reshape(B, 1, KV, G, hd)
    valid = cache_pos >= 0
    mask = valid & (cache_pos <= step)
    if cfg.sliding_window is not None:
        mask &= cache_pos > (step - cfg.sliding_window)
    out = _scores_softmax_out(qg, cache_k, cache_v, mask[:, None, :], scale)
    y = dense(p["wo"], out.reshape(B, 1, H * hd))
    return y, cache_k, cache_v, cache_pos


def attn_decode_paged(p: Params, cfg, x: torch.Tensor,
                      k_pages: torch.Tensor, v_pages: torch.Tensor,
                      page_table: torch.Tensor, lengths: torch.Tensor,
                      flags: Flags = DEFAULT_FLAGS):
    """One-token batched decode straight against the paged KV pool.

    x           [B, 1, D]
    k/v_pages   [P, T, KV, hd]   one layer's pools (strided views allowed)
    page_table  [B, MP] int32    pool page indices (-1 = unmapped pad)
    lengths     [B] int32        tokens already stored per sequence

    The new token's K/V is scattered **in place** into each sequence's
    tail page (``page_table[b, lengths[b] // T]`` must be mapped), then
    attention runs over ``lengths + 1`` tokens through the page table.
    Active sequences must not share a tail page.

    Returns (y, k_pages, v_pages).
    """
    from repro_torch.kernels import ops as kops
    B = x.shape[0]
    T = k_pages.shape[1]
    H, hd = cfg.num_heads, cfg.head_dim_
    positions = lengths[:, None].to(torch.int32)  # == dense path's step
    q, k, v = _qkv(p, cfg, x, positions)

    tail = torch.gather(page_table, 1, (lengths[:, None] // T).long())[:, 0]
    tail = tail.clamp(min=0).long()                 # contract: mapped
    off = (lengths % T).long()
    k_pages[tail, off] = k[:, 0].to(k_pages.dtype)  # in place
    v_pages[tail, off] = v[:, 0].to(v_pages.dtype)  # in place

    out = kops.paged_attention_decode(q[:, 0].contiguous(), k_pages,
                                      v_pages, page_table,
                                      (lengths + 1).to(torch.int32))
    y = dense(p["wo"], out.reshape(B, 1, H * hd))
    return y, k_pages, v_pages


# ---------------------------------------------------------- cross-attention
def cross_attn_init(gen: torch.Generator, cfg,
                    n: Optional[int] = None) -> Params:
    return attention_init(gen, cfg, n)


def cross_attn(p: Params, cfg, x: torch.Tensor, enc_k: torch.Tensor,
               enc_v: torch.Tensor, enc_mask: Optional[torch.Tensor] = None,
               flags: Flags = DEFAULT_FLAGS) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V (no RoPE, not
    causal).  ``enc_mask`` is accepted and unused, as in the reference."""
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim_
    q = dense(p["wq"], x).reshape(B, S, H, hd)
    Sk = enc_k.shape[1]
    qpos = torch.arange(S, device=x.device)[None].expand(B, S)
    kpos = torch.arange(Sk, device=x.device)[None].expand(B, Sk)
    out = chunked_attention(q, enc_k, enc_v, qpos, kpos, causal=False,
                            flags=flags)
    return dense(p["wo"], out.reshape(B, S, -1))


def cross_kv(p: Params, cfg, enc_out: torch.Tensor):
    """Precompute cross-attention K/V from the encoder output."""
    B, Sk, _ = enc_out.shape
    KV, hd = cfg.num_kv_heads, cfg.head_dim_
    k = dense(p["wk"], enc_out).reshape(B, Sk, KV, hd)
    v = dense(p["wv"], enc_out).reshape(B, Sk, KV, hd)
    return k, v
