"""LM trunk: DENSE, MOE, HYBRID and RWKV6 blocks, full-sequence, prefill
and decode (port of repro.models.transformer).

Layer params are stacked on a leading [L] axis, as in the reference; where
the reference scans over layers (``scan_layers``), the port runs a Python
loop over per-layer views, so ``models/scan_utils.py`` has no counterpart.
Caches and pools are updated **in place**.  The full-sequence trunk
(:func:`trunk_train`) is training's forward pass and the encoder-decoder's
encoder; under ``flags.remat`` each layer's body is activation-checkpointed
(:func:`_remat`, the reference's ``jax.checkpoint`` around its scan body).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import DENSE, HYBRID, MOE, RWKV6, ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.flags import Flags
from repro_torch.models.layers import (Params, dtype_of, mlp_apply,
                                       mlp_init, rms_norm, rms_norm_init)
from repro_torch.sharding.constraints import constrain

#: the recurrent state an RWKV6 layer keeps in the decode cache
RWKV_KEYS = ("tmix_prev", "wkv", "cmix_prev")
#: a HYBRID layer's SSM state, kept beside its KV
SSM_KEYS = ("conv", "ssm")


def _layer_keys(cfg: ArchConfig) -> tuple:
    """The [L]-stacked leaves of the decode cache."""
    if cfg.block_type == RWKV6:
        return RWKV_KEYS
    return ("k", "v") + (SSM_KEYS if cfg.block_type == HYBRID else ())


# ---------------------------------------------------------------- layer init
def stacked_layers_init(gen: torch.Generator, cfg: ArchConfig, n: int,
                        cross: bool = False) -> Params:
    """[L]-stacked layer params drawn from ``gen``; ``cross`` adds a
    decoder layer's cross-attention and its norm."""
    p: Params = {"norm1": rms_norm_init(cfg.d_model, gen.device, n),
                 "norm2": rms_norm_init(cfg.d_model, gen.device, n)}
    if cfg.block_type == RWKV6:
        p["rwkv"] = rwkv_mod.rwkv_init(gen, cfg, n)
        return p
    p["attn"] = attn.attention_init(gen, cfg, n)
    if cfg.block_type == MOE:
        p["moe"] = moe_mod.moe_init(gen, cfg, n)
    else:
        p["mlp"] = mlp_init(gen, cfg, n)
    if cfg.block_type == HYBRID:
        p["ssm"] = ssm_mod.ssm_init(gen, cfg, n)
        p["fuse_norm_a"] = rms_norm_init(cfg.d_model, gen.device, n)
        p["fuse_norm_s"] = rms_norm_init(cfg.d_model, gen.device, n)
    if cross:
        p["cross"] = attn.cross_attn_init(gen, cfg, n)
        p["norm3"] = rms_norm_init(cfg.d_model, gen.device, n)
    return p


def layer(layers: Params, l: int) -> Params:
    """Layer ``l``'s params: views into the [L]-stacked tree."""
    return {k: layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in layers.items()}


def unstack(layers: Params) -> list:
    """Every layer's params at once, one ``torch.unbind`` per stacked leaf.
    For training: the backward pass stacks the layers' gradients in one
    copy, where taking each layer apart (:func:`layer`) would give every
    layer a zeroed gradient of the whole stacked leaf, then sum them."""
    per = {k: unstack(v) if isinstance(v, dict) else torch.unbind(v)
           for k, v in layers.items()}
    n = len(next(iter(per.values())))
    return [{k: v[l] for k, v in per.items()} for l in range(n)]


def num_layers(layers: Params) -> int:
    return layers["norm1"]["scale"].shape[0]


#: the ops whose outputs the "dots" policy keeps: matmuls without batch
#: dims (``dots_with_no_batch_dims_saveable``); ``aten.bmm`` (the experts'
#: batched products) is recomputed, as a batched dot is in the reference
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(body, flags: Flags):
    """``body`` under activation checkpointing when ``flags.remat``: policy
    ``"nothing"`` recomputes every activation in the backward pass,
    ``"dots"`` keeps the outputs of the matmuls without batch dims.  Without
    grad mode there is no backward pass to recompute for, so the body runs
    as it is (``jax.checkpoint`` changes nothing in a forward pass either)."""
    if not flags.remat:
        return body
    kwargs = {}
    if flags.remat_policy == "dots":
        kwargs["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        return ckpt.checkpoint(body, *args, use_reentrant=False, **kwargs)
    return wrapped


# -------------------------------------------------------------- block bodies
def _ffn(p: Params, cfg: ArchConfig, x: torch.Tensor, flags: Flags):
    """The block's FFN: experts (MOE) or the MLP.  Returns (y, aux loss);
    the MLP's aux is 0."""
    if cfg.block_type == MOE:
        return moe_mod.moe_apply(p["moe"], cfg, x, flags)
    return mlp_apply(p["mlp"], x, cfg.act), 0.0


def _fuse(p: Params, cfg: ArchConfig, a: torch.Tensor,
          s: torch.Tensor) -> torch.Tensor:
    """HYBRID: the mean of the normed attention and SSM branches."""
    return 0.5 * (rms_norm(p["fuse_norm_a"], a, cfg.norm_eps)
                  + rms_norm(p["fuse_norm_s"], s, cfg.norm_eps))


def block_train(p: Params, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, flags: Flags,
                causal: bool = True):
    """Full-sequence block (the encoder; training's forward).  Returns
    (x, aux loss)."""
    if cfg.block_type == RWKV6:
        x = constrain(x, "residual")
        prev, st, _ = rwkv_mod.rwkv_state_init(cfg, x.shape[0], x.device,
                                               x.dtype)
        h, _, _ = rwkv_mod.time_mix(p["rwkv"], cfg, rms_norm(
            p["norm1"], x, cfg.norm_eps), prev, st, flags)
        x = x + h
        h, _ = rwkv_mod.channel_mix(p["rwkv"], cfg, rms_norm(
            p["norm2"], x, cfg.norm_eps), prev)
        return constrain(x + h, "residual"), 0.0
    x = constrain(x, "residual")
    xn = rms_norm(p["norm1"], x, cfg.norm_eps)
    a = attn.attn_forward(p["attn"], cfg, xn, positions, causal=causal,
                          flags=flags)
    if cfg.block_type == HYBRID:
        cs, ss = ssm_mod.ssm_state_init(cfg, x.shape[0], x.device, x.dtype)
        s, _, _ = ssm_mod.ssm_apply(p["ssm"], cfg, xn, cs, ss, flags)
        a = _fuse(p, cfg, a, s)
    x = x + a
    y, aux = _ffn(p, cfg, rms_norm(p["norm2"], x, cfg.norm_eps), flags)
    return constrain(x + y, "residual"), aux


def trunk_train(layers: Params, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, flags: Flags,
                causal: bool = True):
    """Loop over layers for full sequences, each layer under
    :func:`_remat`; returns (x, the layers' summed aux loss as an f32
    scalar tensor)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    body = _remat(block_train, flags)
    for lp in unstack(layers):
        x, a = body(lp, cfg, x, positions, flags, causal)
        aux = aux + a
    return x, aux


# ----------------------------------------------------------------- caches
def cache_len(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device,
               n_layers: Optional[int] = None) -> Dict[str, Any]:
    """Zeroed decode cache (stacked [L] leaves).  pos slots start at -1;
    ``step`` is a 0-d int32 tensor on ``device``, as in the reference, so
    the decode step reads it on the device only.  An RWKV6 cache holds
    each layer's recurrent state and no KV."""
    L = n_layers or cfg.num_layers
    dt = dtype_of(cfg)
    step = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.block_type == RWKV6:
        N = cfg.rwkv_head_dim
        H = cfg.d_model // N
        D = cfg.d_model
        return {"step": step,
                "tmix_prev": torch.zeros((L, batch, 1, D), dtype=dt,
                                         device=device),
                "wkv": torch.zeros((L, batch, H, N, N), dtype=torch.float32,
                                   device=device),
                "cmix_prev": torch.zeros((L, batch, 1, D), dtype=dt,
                                         device=device)}
    C = cache_len(cfg, seq_len)
    KV, hd = cfg.num_kv_heads, cfg.head_dim_
    cache = {"step": step,
             "k": torch.zeros((L, batch, C, KV, hd), dtype=dt, device=device),
             "v": torch.zeros((L, batch, C, KV, hd), dtype=dt, device=device),
             "pos": torch.full((batch, C), -1, dtype=torch.int32,
                               device=device)}
    if cfg.block_type == HYBRID:
        d_in, H, P = ssm_mod.ssm_dims(cfg)
        cache["conv"] = torch.zeros((L, batch, ssm_mod.CONV_K - 1, d_in),
                                    dtype=dt, device=device)
        cache["ssm"] = torch.zeros((L, batch, H, P, cfg.ssm_state),
                                   dtype=torch.float32, device=device)
    return cache


def _ring_fill(cache_arr: torch.Tensor, vals: torch.Tensor, C: int) -> None:
    """Write the last C of S computed entries into a ring cache in place.

    cache_arr [B, C, ...]; vals [B, S, ...].  Token t lands in slot
    t % C, so the last C tokens fill two contiguous runs of slots; slices,
    not an index tensor, so a cache sharded over its slots takes the write
    shard by shard."""
    S = vals.shape[1]
    if C >= S:
        cache_arr[:, :S] = vals
        return
    r = (S - C) % C                     # the slot of token S - C
    cache_arr[:, r:] = vals[:, S - C:S - r]
    if r:
        cache_arr[:, :r] = vals[:, S - r:]


# ------------------------------------------------------------ prefill/decode
def block_prefill(p: Params, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor, flags: Flags):
    """Block over the prompt; returns (x, per-layer cache entries)."""
    if cfg.block_type == RWKV6:
        prev, st, _ = rwkv_mod.rwkv_state_init(cfg, x.shape[0], x.device,
                                               x.dtype)
        xn = rms_norm(p["norm1"], x, cfg.norm_eps)
        h, tprev, st = rwkv_mod.time_mix(p["rwkv"], cfg, xn, prev, st, flags)
        x = x + h
        xn2 = rms_norm(p["norm2"], x, cfg.norm_eps)
        h, cprev = rwkv_mod.channel_mix(p["rwkv"], cfg, xn2, prev)
        return x + h, {"tmix_prev": tprev, "wkv": st, "cmix_prev": cprev}
    xn = rms_norm(p["norm1"], x, cfg.norm_eps)
    a, (k, v) = attn.attn_forward(p["attn"], cfg, xn, positions, causal=True,
                                  flags=flags, return_kv=True)
    entries = {"k": k, "v": v}
    if cfg.block_type == HYBRID:
        cs, ss = ssm_mod.ssm_state_init(cfg, x.shape[0], x.device, x.dtype)
        s, entries["conv"], entries["ssm"] = ssm_mod.ssm_apply(
            p["ssm"], cfg, xn, cs, ss, flags)
        a = _fuse(p, cfg, a, s)
    x = x + a
    y, _ = _ffn(p, cfg, rms_norm(p["norm2"], x, cfg.norm_eps), flags)
    return x + y, entries


def trunk_prefill(layers: Params, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor, flags: Flags,
                  cache: Dict[str, Any]):
    """Prefill trunk: loop over layers, filling a fresh cache [L, ...]."""
    S = x.shape[1]
    new_cache = dict(cache)
    keys = _layer_keys(cfg)
    for key in keys:
        new_cache[key] = torch.zeros_like(cache[key])
    for l in range(num_layers(layers)):
        x, entries = block_prefill(layer(layers, l), cfg, x, positions, flags)
        for key in keys:
            if key in ("k", "v"):
                _ring_fill(new_cache[key][l], entries[key],
                           cache[key].shape[2])           # in place
            else:
                new_cache[key][l] = entries[key]          # in place
    new_cache["step"] = torch.full_like(cache["step"], S)
    if "pos" in cache:
        pos = cache["pos"].clone()
        _ring_fill(pos, positions.to(torch.int32), pos.shape[1])
        new_cache["pos"] = pos
    return x, new_cache


def block_decode(p: Params, cfg: ArchConfig, x: torch.Tensor,
                 layer_cache: Dict[str, torch.Tensor],
                 pos_slots: Optional[torch.Tensor], step: torch.Tensor,
                 flags: Flags):
    """One-token decode for one layer; updates the layer's cache views in
    place.  Returns x."""
    if cfg.block_type == RWKV6:
        xn = rms_norm(p["norm1"], x, cfg.norm_eps)
        h, tprev, wkv = rwkv_mod.time_mix(
            p["rwkv"], cfg, xn, layer_cache["tmix_prev"],
            layer_cache["wkv"], flags, decode=True)
        x = x + h
        xn2 = rms_norm(p["norm2"], x, cfg.norm_eps)
        h, cprev = rwkv_mod.channel_mix(p["rwkv"], cfg, xn2,
                                        layer_cache["cmix_prev"])
        layer_cache["tmix_prev"].copy_(tprev)
        layer_cache["wkv"].copy_(wkv)
        layer_cache["cmix_prev"].copy_(cprev)
        return x + h
    xn = rms_norm(p["norm1"], x, cfg.norm_eps)
    a, _, _, _ = attn.attn_decode(p["attn"], cfg, xn, layer_cache["k"],
                                  layer_cache["v"], pos_slots, step, flags)
    if cfg.block_type == HYBRID:
        s, cs, ss = ssm_mod.ssm_apply(p["ssm"], cfg, xn, layer_cache["conv"],
                                      layer_cache["ssm"], flags, decode=True)
        layer_cache["conv"].copy_(cs)
        layer_cache["ssm"].copy_(ss)
        a = _fuse(p, cfg, a, s)
    x = x + a
    y, _ = _ffn(p, cfg, rms_norm(p["norm2"], x, cfg.norm_eps), flags)
    return x + y


def trunk_decode(layers: Params, cfg: ArchConfig, x: torch.Tensor,
                 cache: Dict[str, Any], flags: Flags):
    """Loop over layers against the per-layer caches; the cache is
    updated in place and returned.  ``step`` stays on the device: it is
    passed down as a tensor and advanced in place, so a step captured
    against a static cache moves it on at every replay."""
    step = cache["step"]
    keys = _layer_keys(cfg)
    # every layer writes the same new position into its slot (in place),
    # so the one shared pos tensor serves them all
    for l in range(num_layers(layers)):
        x = block_decode(layer(layers, l), cfg, x,
                         {key: cache[key][l] for key in keys},
                         cache.get("pos"), step, flags)
    step.add_(1)
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
    each sequence's tail page in place.  Returns x.  DENSE and MOE blocks
    (their bodies mirror :func:`block_decode`'s with the paged attention).
    """
    if cfg.block_type not in (DENSE, MOE):
        raise NotImplementedError(
            f"{cfg.name}: paged decode covers DENSE and MOE blocks only")
    for l in range(num_layers(layers)):
        lp = layer(layers, l)
        xn = rms_norm(lp["norm1"], x, cfg.norm_eps)
        a, _, _ = attn.attn_decode_paged(lp["attn"], cfg, xn, pool[:, l, 0],
                                         pool[:, l, 1], page_table, lengths,
                                         flags)
        x = x + a
        x = x + _ffn(lp, cfg, rms_norm(lp["norm2"], x, cfg.norm_eps),
                     flags)[0]
    return x
