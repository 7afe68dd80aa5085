"""Encoder-decoder trunk (seamless-m4t): an encoder and a cross-attending
decoder (port of ``repro.models.encdec``).

The audio frontend is a stub: the encoder consumes precomputed frame
embeddings [B, S_src, D] (``models/frontend.py`` draws them).  Decoder
layers carry self-attention (cached at decode) and cross-attention over
the encoder output, whose K/V are computed once at prefill and stored
[L, B, S_src, KV, hd].  As elsewhere in the port, the decode step updates
the cache **in place** and returns it; ``step`` is a 0-d int32 tensor on
the cache's device, advanced in place.
Training runs the teacher-forced decoder (:func:`decode_train`), each
layer under ``_remat`` as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.flags import Flags
from repro_torch.models.layers import Params, dtype_of, rms_norm
from repro_torch.models.transformer import (_ffn, _remat, init_cache,
                                            layer, num_layers,
                                            stacked_layers_init, trunk_train,
                                            unstack)


def encdec_init(gen: torch.Generator, cfg: ArchConfig) -> Params:
    return {
        "enc": stacked_layers_init(gen, cfg, cfg.num_encoder_layers),
        "dec": stacked_layers_init(gen, cfg, cfg.num_layers, cross=True),
    }


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def encode(layers: Params, cfg: ArchConfig, src_emb: torch.Tensor,
           flags: Flags) -> torch.Tensor:
    """The encoder: the full-sequence trunk, not causal, RoPE on its
    self-attention."""
    B, S, _ = src_emb.shape
    x, _ = trunk_train(layers["enc"], cfg, src_emb,
                       _positions(B, S, src_emb.device), flags, causal=False)
    return x


def init_encdec_cache(cfg: ArchConfig, batch: int, seq_len: int,
                      src_len: int, device) -> Dict[str, Any]:
    cache = init_cache(cfg, batch, seq_len, device, n_layers=cfg.num_layers)
    shape = (cfg.num_layers, batch, src_len, cfg.num_kv_heads, cfg.head_dim_)
    cache["cross_k"] = torch.zeros(shape, dtype=dtype_of(cfg), device=device)
    cache["cross_v"] = torch.zeros(shape, dtype=dtype_of(cfg), device=device)
    return cache


def _dec_tail(p: Params, cfg: ArchConfig, x: torch.Tensor,
              enc_k: torch.Tensor, enc_v: torch.Tensor,
              flags: Flags) -> torch.Tensor:
    """A decoder layer after its self-attention: cross-attention over the
    encoder's K/V, then the FFN."""
    xn = rms_norm(p["norm3"], x, cfg.norm_eps)
    x = x + attn.cross_attn(p["cross"], cfg, xn, enc_k, enc_v, flags=flags)
    y, _ = _ffn(p, cfg, rms_norm(p["norm2"], x, cfg.norm_eps), flags)
    return x + y


def _dec_block_train(p: Params, cfg: ArchConfig, x: torch.Tensor,
                     positions: torch.Tensor, enc_out: torch.Tensor,
                     flags: Flags) -> torch.Tensor:
    """One decoder layer over the whole target: causal self-attention,
    cross-attention over the encoder output, the FFN."""
    xn = rms_norm(p["norm1"], x, cfg.norm_eps)
    x = x + attn.attn_forward(p["attn"], cfg, xn, positions, causal=True,
                              flags=flags)
    ek, ev = attn.cross_kv(p["cross"], cfg, enc_out)
    return _dec_tail(p, cfg, x, ek, ev, flags)


def decode_train(layers: Params, cfg: ArchConfig, tgt_emb: torch.Tensor,
                 enc_out: torch.Tensor, flags: Flags) -> torch.Tensor:
    """Teacher-forced decoder pass."""
    B, S, _ = tgt_emb.shape
    positions = _positions(B, S, tgt_emb.device)
    body = _remat(_dec_block_train, flags)
    x = tgt_emb
    for lp in unstack(layers["dec"]):
        x = body(lp, cfg, x, positions, enc_out, flags)
    return x


def prefill(layers: Params, cfg: ArchConfig, tgt_emb: torch.Tensor,
            enc_out: torch.Tensor, cache: Dict[str, Any], flags: Flags):
    """Encoder output + target prefix -> hidden states + a filled cache.

    Self K/V go into the cache's C slots from slot 0 (the rest stay zero
    when S < C; a prefix longer than C keeps its first C, as the
    reference's does); ``pos`` holds each filled slot's position and -1
    past S.  Cross K/V come from ``enc_out``, whatever ``src_len`` the
    cache was made for."""
    B, S, _ = tgt_emb.shape
    positions = _positions(B, S, tgt_emb.device)
    C = cache["k"].shape[2]
    n = min(S, C)
    L = num_layers(layers["dec"])
    new_cache = dict(cache)
    new_cache["k"] = torch.zeros_like(cache["k"])
    new_cache["v"] = torch.zeros_like(cache["v"])
    cross_shape = (L, B, enc_out.shape[1], cfg.num_kv_heads, cfg.head_dim_)
    new_cache["cross_k"] = enc_out.new_empty(cross_shape)
    new_cache["cross_v"] = enc_out.new_empty(cross_shape)
    x = tgt_emb
    for l in range(L):
        lp = layer(layers["dec"], l)
        xn = rms_norm(lp["norm1"], x, cfg.norm_eps)
        a, (k, v) = attn.attn_forward(lp["attn"], cfg, xn, positions,
                                      causal=True, flags=flags,
                                      return_kv=True)
        x = x + a
        ek, ev = attn.cross_kv(lp["cross"], cfg, enc_out)
        x = _dec_tail(lp, cfg, x, ek, ev, flags)
        new_cache["k"][l, :, :n] = k[:, :n]                 # in place
        new_cache["v"][l, :, :n] = v[:, :n]
        new_cache["cross_k"][l] = ek
        new_cache["cross_v"][l] = ev
    new_cache["step"] = torch.full_like(cache["step"], S)
    slots = torch.arange(C, device=tgt_emb.device)
    pos_row = torch.where(slots < S, slots, -1).to(torch.int32)
    new_cache["pos"] = pos_row[None].expand(B, C).clone()
    return x, new_cache


def decode_step(layers: Params, cfg: ArchConfig, x: torch.Tensor,
                cache: Dict[str, Any], flags: Flags):
    """One target token per sequence: self-attention writes its K/V and
    position at slot ``step % C`` in place (every layer the same slot of
    the one shared ``pos``), then cross-attention and the FFN.  Returns
    (x, cache)."""
    step = cache["step"]
    for l in range(num_layers(layers["dec"])):
        lp = layer(layers["dec"], l)
        xn = rms_norm(lp["norm1"], x, cfg.norm_eps)
        a, _, _, _ = attn.attn_decode(lp["attn"], cfg, xn, cache["k"][l],
                                      cache["v"][l], cache["pos"], step,
                                      flags)
        x = _dec_tail(lp, cfg, x + a, cache["cross_k"][l],
                      cache["cross_v"][l], flags)
    step.add_(1)
    return x, cache
