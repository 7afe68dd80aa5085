"""Decoder-only LM trunk, DENSE blocks (port of repro.models.transformer).

Layer params are stacked on a leading [L] axis, as in the reference; where
the reference scans over layers (``scan_layers``), the port runs a Python
loop over per-layer views.  Caches and pools are updated **in place**.
MoE, RWKV6, hybrid and encoder-decoder blocks are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import DENSE, ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.flags import Flags
from repro_torch.models.layers import (Params, dtype_of, mlp_apply,
                                       mlp_init, rms_norm, rms_norm_init)


def check_supported(cfg: ArchConfig) -> None:
    if cfg.encoder_decoder or cfg.block_type != DENSE:
        kind = "encoder-decoder" if cfg.encoder_decoder else cfg.block_type
        raise NotImplementedError(
            f"{cfg.name}: {kind} blocks are not ported to repro_torch yet "
            "(only DENSE decoder-only models are)")


# ---------------------------------------------------------------- layer init
def stacked_layers_init(gen: torch.Generator, cfg: ArchConfig,
                        n: int) -> Params:
    """[L]-stacked DENSE layer params drawn from ``gen``."""
    check_supported(cfg)
    return {"norm1": rms_norm_init(cfg.d_model, gen.device, n),
            "norm2": rms_norm_init(cfg.d_model, gen.device, n),
            "attn": attn.attention_init(gen, cfg, n),
            "mlp": mlp_init(gen, cfg, n)}


def layer(layers: Params, l: int) -> Params:
    """Layer ``l``'s params: views into the [L]-stacked tree."""
    return {k: layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in layers.items()}


def num_layers(layers: Params) -> int:
    return layers["norm1"]["scale"].shape[0]


# ----------------------------------------------------------------- caches
def cache_len(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device,
               n_layers: Optional[int] = None) -> Dict[str, Any]:
    """Zeroed decode cache (stacked [L] leaves).  pos slots start at -1;
    ``step`` is a host integer."""
    check_supported(cfg)
    L = n_layers or cfg.num_layers
    dt = dtype_of(cfg)
    C = cache_len(cfg, seq_len)
    KV, hd = cfg.num_kv_heads, cfg.head_dim_
    return {"step": 0,
            "k": torch.zeros((L, batch, C, KV, hd), dtype=dt, device=device),
            "v": torch.zeros((L, batch, C, KV, hd), dtype=dt, device=device),
            "pos": torch.full((batch, C), -1, dtype=torch.int32,
                              device=device)}


def _ring_fill(cache_arr: torch.Tensor, vals: torch.Tensor, C: int) -> None:
    """Write the last C of S computed entries into a ring cache in place.

    cache_arr [B, C, ...]; vals [B, S, ...]."""
    S = vals.shape[1]
    if C >= S:
        cache_arr[:, :S] = vals
        return
    idx = torch.arange(S - C, S, device=vals.device) % C
    cache_arr[:, idx] = vals[:, S - C:]


# ------------------------------------------------------------ prefill/decode
def block_prefill(p: Params, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor, flags: Flags):
    """Block over the prompt; returns (x, (k, v))."""
    xn = rms_norm(p["norm1"], x, cfg.norm_eps)
    a, kv = attn.attn_forward(p["attn"], cfg, xn, positions, causal=True,
                              flags=flags, return_kv=True)
    x = x + a
    y = mlp_apply(p["mlp"], rms_norm(p["norm2"], x, cfg.norm_eps), cfg.act)
    return x + y, kv


def trunk_prefill(layers: Params, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor, flags: Flags,
                  cache: Dict[str, Any]):
    """Prefill trunk: loop over layers, filling a fresh cache [L, ...]."""
    check_supported(cfg)
    S = x.shape[1]
    new_cache = dict(cache)
    new_cache["k"] = torch.zeros_like(cache["k"])
    new_cache["v"] = torch.zeros_like(cache["v"])
    C = cache["k"].shape[2]
    for l in range(num_layers(layers)):
        x, (k, v) = block_prefill(layer(layers, l), cfg, x, positions, flags)
        _ring_fill(new_cache["k"][l], k, C)     # in place
        _ring_fill(new_cache["v"][l], v, C)     # in place
    new_cache["step"] = S
    pos = cache["pos"].clone()
    _ring_fill(pos, positions.to(torch.int32), pos.shape[1])
    new_cache["pos"] = pos
    return x, new_cache


def block_decode(p: Params, cfg: ArchConfig, x: torch.Tensor,
                 cache_k: torch.Tensor, cache_v: torch.Tensor,
                 pos_slots: torch.Tensor, step: int, flags: Flags):
    """One-token decode for one layer; updates the layer's caches in
    place.  Returns x."""
    xn = rms_norm(p["norm1"], x, cfg.norm_eps)
    a, _, _, _ = attn.attn_decode(p["attn"], cfg, xn, cache_k, cache_v,
                                  pos_slots, step, flags)
    x = x + a
    y = mlp_apply(p["mlp"], rms_norm(p["norm2"], x, cfg.norm_eps), cfg.act)
    return x + y


def trunk_decode(layers: Params, cfg: ArchConfig, x: torch.Tensor,
                 cache: Dict[str, Any], flags: Flags):
    """Loop over layers against the per-layer caches; the cache is
    updated in place and returned."""
    check_supported(cfg)
    step = int(cache["step"])
    # every layer writes the same new position into its slot (in place),
    # so the one shared pos tensor serves them all
    for l in range(num_layers(layers)):
        x = block_decode(layer(layers, l), cfg, x, cache["k"][l],
                         cache["v"][l], cache["pos"], step, flags)
    cache["step"] = step + 1
    return x, cache


def trunk_decode_paged(layers: Params, cfg: ArchConfig, x: torch.Tensor,
                       pool: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor, flags: Flags):
    """Decode one token per sequence straight from the paged KV pool.

    x          [B, 1, D]
    pool       [P, L, 2, T, KV, hd]  the serving pool (PagedKVStore layout)
    page_table [B, MP] int32         pool page indices (-1 pad)
    lengths    [B] int32             tokens stored per sequence (pre-step)

    Each layer reads the strided views ``pool[:, l, 0]`` / ``pool[:, l, 1]``
    (no restacking of the pool) and the new token's K/V is scattered into
    each sequence's tail page in place.  Returns x.
    """
    check_supported(cfg)
    for l in range(num_layers(layers)):
        lp = layer(layers, l)
        xn = rms_norm(lp["norm1"], x, cfg.norm_eps)
        a, _, _ = attn.attn_decode_paged(lp["attn"], cfg, xn, pool[:, l, 0],
                                         pool[:, l, 1], page_table, lengths,
                                         flags)
        x = x + a
        y = mlp_apply(lp["mlp"], rms_norm(lp["norm2"], x, cfg.norm_eps),
                      cfg.act)
        x = x + y
    return x
