"""Multi-head latent attention (MLA, DeepSeek-V3), which the JAX package
does not have.

Equations (``transformers``' ``modeling_deepseek_v3.py``, DeepSeek's own
inference code):

* ``q = wq_b(q_norm(wq_a(x)))``, each of the H heads split into a part
  without positions (``qk_nope_head_dim``) and a RoPE part
  (``qk_rope_head_dim``);
* ``[c, k_r] = wkv_a(x)``, ``c = kv_norm(c)``: the ``kv_lora_rank``-wide
  latent and one RoPE key that every head shares;
* RoPE rotates adjacent pairs (``rope_interleave``), at YaRN's
  frequencies (:func:`rope_frequencies`) with cos and sin scaled by
  YaRN's attention factor (1 for DeepSeek-V3);
* the softmax scale is ``(nope + rope) ** -0.5`` times the square of
  YaRN's ``mscale_all_dim`` factor (:func:`softmax_scale`).

A token's cache row (:func:`latent_width` wide) is ``[c, rope(k_r)]``.
Prefill runs the expanded form (:func:`mla_prefill`): ``[k_nope, v] =
wkv_b(c)``, causal attention of q/k ``nope + rope`` wide and v
``v_head_dim`` wide through the flash kernel.  Paged decode runs the
absorbed form (:func:`mla_decode_paged`): ``wkv_b``'s key half folded
into q per head (``q_lat = q_nope W_UK``), scores ``q_lat . c + q_r .
k_r`` against the cached rows through ``kernels/mla_decode.py``, then
``(p . c) W_UV`` per head: the same function of the weights, computed
without expanding the cache.

The pair rotation returns each head's rotated values with the pairs'
first members first and their second members after, as ``transformers``
does; q and k are permuted alike, so their products are the pairwise
rotation's.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models.flags import DEFAULT_FLAGS, Flags
from repro_torch.models.layers import (Params, dense, dense_init, dtype_of,
                                       rms_norm, rms_norm_init)


def latent_width(cfg) -> int:
    """The width of a token's cache row: the latent and the RoPE key."""
    return cfg.kv_lora_rank + cfg.qk_rope_head_dim


def mla_init(gen: torch.Generator, cfg, n: Optional[int] = None) -> Params:
    """One layer's params (``n`` stacks ``n`` layers); each ``w`` is
    [in, out], as ``layers.dense`` takes it."""
    dt = dtype_of(cfg)
    D, H = cfg.d_model, cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": dense_init(gen, D, cfg.q_lora_rank, dt, n=n),
        "q_norm": rms_norm_init(cfg.q_lora_rank, gen.device, n),
        "wq_b": dense_init(gen, cfg.q_lora_rank, H * (dn + dr), dt, n=n),
        "wkv_a": dense_init(gen, D, cfg.kv_lora_rank + dr, dt, n=n),
        "kv_norm": rms_norm_init(cfg.kv_lora_rank, gen.device, n),
        "wkv_b": dense_init(gen, cfg.kv_lora_rank, H * (dn + dv), dt, n=n),
        "wo": dense_init(gen, H * dv, D, dt, n=n),
    }


# ------------------------------------------------------------------ YaRN
def _yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def softmax_scale(cfg) -> float:
    """``(nope + rope) ** -0.5``, times ``mscale_all_dim``'s factor
    squared under YaRN: 0.135234 for DeepSeek-V3."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if cfg.yarn_factor and cfg.yarn_mscale_all_dim:
        scale *= _yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) ** 2
    return scale


def _attention_factor(cfg) -> float:
    """YaRN's scale of cos and sin (1 when both mscales are equal)."""
    if not cfg.yarn_factor:
        return 1.0
    if cfg.yarn_mscale and cfg.yarn_mscale_all_dim:
        return (_yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale)
                / _yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim))
    return _yarn_mscale(cfg.yarn_factor, 1.0)


def _correction_range(cfg, dim: int) -> Tuple[int, int]:
    """The dims between which YaRN ramps from extrapolated to interpolated
    frequencies (floored and ceiled, clamped to the head)."""
    base, orig = cfg.rope_theta, cfg.yarn_original_max_position

    def at(rotations):
        return (dim * math.log(orig / (rotations * 2 * math.pi))
                / (2 * math.log(base)))
    low = math.floor(at(cfg.yarn_beta_fast))
    high = math.ceil(at(cfg.yarn_beta_slow))
    return max(low, 0), min(high, dim - 1)


def rope_frequencies(cfg, device) -> torch.Tensor:
    """The RoPE part's ``qk_rope_head_dim / 2`` inverse frequencies, f32:
    plain RoPE's, or under YaRN those past the ramp divided by the
    factor."""
    dim = cfg.qk_rope_head_dim
    pos = cfg.rope_theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=device) / dim)
    extra = 1.0 / pos
    if not cfg.yarn_factor:
        return extra
    low, high = _correction_range(cfg, dim)
    span = (high - low) or 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / span).clamp(0, 1)
    keep = 1.0 - ramp                    # the extrapolated share
    return extra / cfg.yarn_factor * (1.0 - keep) + extra * keep


def rope_tables(cfg, positions: torch.Tensor) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """positions [*, S] -> (sin, cos) each [*, S, rope / 2], f32, scaled by
    YaRN's attention factor.  A step computes them once for all its
    layers."""
    ang = positions.float()[..., None] * rope_frequencies(cfg,
                                                          positions.device)
    f = _attention_factor(cfg)
    return torch.sin(ang) * f, torch.cos(ang) * f


def rope_pairs(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """Rotate x's adjacent pairs (x[2i], x[2i+1]) by the angles whose sin
    and cos broadcast against ``x[..., ::2]``; returns the rotated first
    members, then the rotated second members, in x's dtype."""
    a, b = x[..., 0::2].float(), x[..., 1::2].float()
    return torch.cat([a * cos - b * sin, b * cos + a * sin],
                     dim=-1).to(x.dtype)


# -------------------------------------------------------------- the forms
def _q(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] -> q [B, S, H, nope + rope]."""
    B, S, _ = x.shape
    q = dense(p["wq_b"], rms_norm(p["q_norm"], dense(p["wq_a"], x),
                                  cfg.norm_eps))
    return q.reshape(B, S, cfg.num_heads, -1)


def _latent(p: Params, cfg, x: torch.Tensor) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """x [B, S, D] -> (normed latent c [B, S, kv_lora_rank], k_r [B, S,
    rope] before RoPE)."""
    ckr = dense(p["wkv_a"], x)
    dc = cfg.kv_lora_rank
    return rms_norm(p["kv_norm"], ckr[..., :dc], cfg.norm_eps), ckr[..., dc:]


def mla_prefill(p: Params, cfg, x: torch.Tensor, rope: tuple,
                flags: Flags = DEFAULT_FLAGS):
    """The expanded form over a prompt: x [B, S, D], ``rope`` the
    prompt's :func:`rope_tables` -> (y [B, S, D], cache rows [B, S,
    latent_width])."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    B, S, _ = x.shape
    H, dn, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    sin, cos = rope
    q = _q(p, cfg, x)
    c, k_r = _latent(p, cfg, x)
    q_r = rope_pairs(q[..., dn:], sin[..., None, :], cos[..., None, :])
    k_r = rope_pairs(k_r, sin, cos)
    kv = dense(p["wkv_b"], c).reshape(B, S, H, dn + dv)
    qf = torch.cat([q[..., :dn], q_r], dim=-1)
    k = torch.cat([kv[..., :dn], k_r[:, :, None].expand(B, S, H, -1)],
                  dim=-1)
    v = kv[..., dn:].contiguous()
    attend = kops.flash_attention if flags.use_kernels else \
        fa.flash_attention_plain
    out = attend(qf, k, v, window=None, scale=softmax_scale(cfg))
    return dense(p["wo"], out.reshape(B, S, H * dv)), \
        torch.cat([c, k_r], dim=-1)


def absorbed_weights(p: Params, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wkv_b`` per head as the absorbed form takes it, views without a
    copy: W_UK [H, nope, kv_lora_rank] (q_nope @ W_UK[h] is q_lat) and
    W_UV [H, kv_lora_rank, v] (o_lat @ W_UV[h] is the head's output)."""
    dn = cfg.qk_nope_head_dim
    w = p["wkv_b"]["w"].view(cfg.kv_lora_rank, cfg.num_heads, -1)
    return w[..., :dn].permute(1, 2, 0), w[..., dn:].permute(1, 0, 2)


def mla_decode_paged(p: Params, cfg, x: torch.Tensor, pages: torch.Tensor,
                     page_table: torch.Tensor, lengths: torch.Tensor,
                     rope: tuple) -> torch.Tensor:
    """The absorbed form, one token a row, against one layer's pages.

    x           [B, 1, D]
    pages       [P, T, latent_width]  one layer's rows (a strided view)
    page_table  [B, MP] int32         pool page indices (-1 = unmapped)
    lengths     [B] int32             tokens already stored per row
    rope        the new tokens' :func:`rope_tables` ([B, 1, rope / 2])

    The new token's row is written **in place** into each row's tail page
    (``page_table[b, lengths[b] // T]`` must be mapped; active rows share
    no tail page), then each head attends ``lengths + 1`` rows.  Returns
    y [B, 1, D]."""
    from repro_torch.kernels import ops as kops
    B, T = x.shape[0], pages.shape[1]
    H, dn, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    sin, cos = rope
    q = _q(p, cfg, x)[:, 0]                           # [B, H, nope+rope]
    c, k_r = _latent(p, cfg, x)
    q_r = rope_pairs(q[..., dn:], sin, cos)           # [B, H, rope]
    row = torch.cat([c, rope_pairs(k_r, sin, cos)], dim=-1)[:, 0]

    tail = torch.gather(page_table, 1, (lengths[:, None] // T).long())[:, 0]
    tail = tail.clamp(min=0).long()                   # contract: mapped
    pages[tail, (lengths % T).long()] = row.to(pages.dtype)   # in place

    w_uk, w_uv = absorbed_weights(p, cfg)
    q_lat = torch.bmm(q[..., :dn].transpose(0, 1), w_uk).transpose(0, 1)
    o = kops.mla_decode(torch.cat([q_lat, q_r.to(q_lat.dtype)], dim=-1),
                        pages, page_table, (lengths + 1).to(torch.int32),
                        scale=softmax_scale(cfg),
                        v_width=cfg.kv_lora_rank)     # [B, H, kv_lora]
    out = torch.bmm(o.transpose(0, 1), w_uv).transpose(0, 1)
    return dense(p["wo"], out.reshape(B, 1, H * dv))
