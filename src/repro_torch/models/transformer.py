"""LM trunk: DENSE, MOE, HYBRID and RWKV6 blocks, full-sequence, prefill
and decode (port of repro.models.transformer).

Layer params are stacked on a leading [L] axis, as in the reference; where
the reference scans over layers (``scan_layers``), the port runs a Python
loop over per-layer views, which a CUDA graph captures
(``models/scan_utils.scan_layers`` is that loop, for callers of the
reference's name).
Caches and pools are updated **in place**.  The full-sequence trunk
(:func:`trunk_train`) is training's forward pass and the encoder-decoder's
encoder; under ``flags.remat`` each layer's body is activation-checkpointed
(:func:`_remat`, the reference's ``jax.checkpoint`` around its scan body).

A mixed stack (``cfg.mixed``: layers of more than one kind, which the
JAX package does not have: k-exaone-236b-a23b, deepseek-v3) keeps its
layers' attention and norms stacked on [L], its leading dense layers' MLP
on [dense_layers] (``mlp``, width ``dense_d_ff``) and the rest's
sigmoid-routed experts on [L - dense_layers] (``moe``);
:func:`mixed_layer` gives layer l's params, and prefill and paged decode
run :func:`mixed_block`, EXAONE 4.0's post-norm block (``cfg.post_norm``)
or the pre-norm one, with layer l's own attention: GQA with its window
and RoPE, or latent attention (``cfg.attention == "mla"``,
``models/mla.py``).  It serves on the paged path only: no training step,
no dense slot step.  Its cache keeps every layer's entries of every
token, windowed layers too: K/V, or one latent row (``latent``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import DENSE, HYBRID, MOE, RWKV6, ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
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
#: the [L]-stacked leaves that hold one entry a token (a prefill resets
#: them): K and V, or latent attention's rows
TOKEN_KEYS = ("k", "v", "latent")


def _layer_keys(cfg: ArchConfig) -> tuple:
    """The [L]-stacked leaves of the decode cache."""
    if cfg.block_type == RWKV6:
        return RWKV_KEYS
    if cfg.attention == "mla":
        return ("latent",)
    return ("k", "v") + (SSM_KEYS if cfg.block_type == HYBRID else ())


# ---------------------------------------------------------------- layer init
def layer_init(gen: torch.Generator, cfg: ArchConfig,
               cross: bool = False) -> Params:
    """One layer's params drawn from ``gen``: the tree of
    :func:`stacked_layers_init` without its leading [L] axis."""
    return stacked_layers_init(gen, cfg, None, cross)


def stacked_layers_init(gen: torch.Generator, cfg: ArchConfig,
                        n: Optional[int], cross: bool = False) -> Params:
    """[L]-stacked layer params drawn from ``gen`` (``n`` None: one
    layer's, unstacked); ``cross`` adds a decoder layer's cross-attention
    and its norm."""
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


# -------------------------------------------------------------- mixed stack
def mixed_init(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """A mixed stack's params: norms and attention (GQA or latent) for all
    L layers, the dense layers' MLP and the other layers' sigmoid-routed
    experts."""
    L = cfg.num_layers
    Ld = min(cfg.dense_layers, L)
    init = mla_mod.mla_init if cfg.attention == "mla" else \
        attn.attention_init
    p: Params = {"norm1": rms_norm_init(cfg.d_model, gen.device, L),
                 "norm2": rms_norm_init(cfg.d_model, gen.device, L),
                 "attn": init(gen, cfg, L)}
    if Ld:
        p["mlp"] = mlp_init(gen, dataclasses.replace(
            cfg, d_ff=cfg.dense_d_ff, act="swiglu"), Ld)
    if L > Ld:
        p["moe"] = moe_mod.routed_init(gen, cfg, L - Ld)
    return p


def mixed_layer(layers: Params, cfg: ArchConfig, l: int) -> Params:
    """Layer ``l``'s params of a mixed stack (views): its norms and
    attention, and the dense MLP or the experts it has."""
    lp = {k: layer(layers[k], l) for k in ("norm1", "norm2", "attn")}
    if l < cfg.dense_layers:
        lp["mlp"] = layer(layers["mlp"], l)
    else:
        lp["moe"] = layer(layers["moe"], l - cfg.dense_layers)
    return lp


def mixed_block(lp: Params, cfg: ArchConfig, x: torch.Tensor, attend,
                trace=None) -> torch.Tensor:
    """One layer of a mixed stack, ``attend(h)`` its attention on ``h``,
    the FFN the dense MLP or the routed experts.  Post-norm
    (``cfg.post_norm``): ``x + norm1(attn(x))``, then ``+ norm2(ffn(.))``;
    pre-norm: ``x + attn(norm1(x))``, then ``+ ffn(norm2(.))``."""
    eps = cfg.norm_eps

    def ffn(h):
        return (mlp_apply(lp["mlp"], h, "swiglu") if "mlp" in lp
                else moe_mod.routed_apply(lp["moe"], cfg, h, trace=trace))
    if cfg.post_norm:
        x = x + rms_norm(lp["norm1"], attend(x), eps)
        return x + rms_norm(lp["norm2"], ffn(x), eps)
    x = x + attend(rms_norm(lp["norm1"], x, eps))
    return x + ffn(rms_norm(lp["norm2"], x, eps))


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
    if cfg.mixed:
        raise NotImplementedError(f"{cfg.name}: a mixed stack serves only")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    body = _remat(block_train, flags)
    for lp in unstack(layers):
        x, a = body(lp, cfg, x, positions, flags, causal)
        aux = aux + a
    return x, aux


# ----------------------------------------------------------------- caches
def cache_len(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None and not cfg.window_pattern:
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
    if cfg.attention == "mla":
        return {"step": step,
                "latent": torch.zeros((L, batch, C, mla_mod.latent_width(cfg)),
                                      dtype=dt, device=device),
                "pos": torch.full((batch, C), -1, dtype=torch.int32,
                                  device=device)}
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


def _mixed_prefill(layers: Params, cfg: ArchConfig, l: int,
                   x: torch.Tensor, positions: torch.Tensor, flags: Flags,
                   trace=None, rope=None):
    """Layer ``l`` of a mixed stack over the prompt: (x, its cache
    entries: K/V, or the latent rows, which take the prompt's
    ``mla.rope_tables``)."""
    lp = mixed_layer(layers, cfg, l)
    kv = {}

    def attend(h):
        if cfg.attention == "mla":
            a, kv["latent"] = mla_mod.mla_prefill(lp["attn"], cfg, h, rope,
                                                  flags)
            return a
        a, (kv["k"], kv["v"]) = attn.attn_forward(
            lp["attn"], cfg, h, positions, causal=True, flags=flags,
            return_kv=True, layer_idx=l)
        return a
    x = mixed_block(lp, cfg, x, attend, trace)
    return x, kv


def trunk_prefill(layers: Params, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor, flags: Flags,
                  cache: Dict[str, Any], trace=None):
    """Prefill trunk: loop over layers, filling ``cache`` [L, ...] in place
    and returning it.  The cache is reset first, whatever it held: K/V
    zeroed and ``pos`` -1, so slots at or past S read as never written
    (the recurrent states are overwritten whole).  One static cache can
    thus take every prefill of a staged engine, each length's graph
    writing into it."""
    S = x.shape[1]
    keys = _layer_keys(cfg)
    for key in TOKEN_KEYS:
        if key in cache:
            cache[key].zero_()
    mixed = cfg.mixed
    rope = (mla_mod.rope_tables(cfg, positions) if cfg.attention == "mla"
            else None)
    for l in range(num_layers(layers)):
        if mixed:
            x, entries = _mixed_prefill(layers, cfg, l, x, positions, flags,
                                        trace, rope)
        else:
            x, entries = block_prefill(layer(layers, l), cfg, x, positions,
                                       flags)
        for key in keys:
            if key in TOKEN_KEYS:
                _ring_fill(cache[key][l], entries[key],
                           cache[key].shape[2])           # in place
            else:
                cache[key][l] = entries[key]              # in place
    cache["step"].fill_(S)
    if "pos" in cache:
        cache["pos"].fill_(-1)
        _ring_fill(cache["pos"], positions.to(torch.int32),
                   cache["pos"].shape[1])
    return x, cache


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
    if cfg.mixed:
        raise NotImplementedError(f"{cfg.name}: a mixed stack decodes on "
                                  "the paged path only")
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
                       lengths: torch.Tensor, flags: Flags, trace=None):
    """Decode one token per sequence straight from the paged KV pool.

    x          [B, 1, D]
    pool       [P, *page]            the serving pool (the model's page
                                     layout, ``models/pages.py``): [P, L,
                                     2, T, KV, hd], or [P, L, T, latent]
    page_table [B, MP] int32         pool page indices (-1 pad)
    lengths    [B] int32             tokens stored per sequence (pre-step)

    Each layer reads strided views of its part of the pool (``pool[:, l,
    0]`` / ``pool[:, l, 1]``, or ``pool[:, l]``; no restacking of the pool)
    and the new token's entries are scattered into each sequence's tail
    page in place.  Returns x.  DENSE and MOE blocks (their bodies mirror
    :func:`block_decode`'s with the paged attention).
    """
    if cfg.block_type not in (DENSE, MOE):
        raise NotImplementedError(
            f"{cfg.name}: paged decode covers DENSE and MOE blocks only")
    mixed = cfg.mixed
    rope = (mla_mod.rope_tables(cfg, lengths[:, None])
            if cfg.attention == "mla" else None)
    for l in range(num_layers(layers)):
        if mixed:
            lp = mixed_layer(layers, cfg, l)
            if rope is not None:
                def attend(h):
                    return mla_mod.mla_decode_paged(
                        lp["attn"], cfg, h, pool[:, l], page_table, lengths,
                        rope)
            else:
                def attend(h):
                    return attn.attn_decode_paged(
                        lp["attn"], cfg, h, pool[:, l, 0], pool[:, l, 1],
                        page_table, lengths, flags, layer_idx=l)[0]
            x = mixed_block(lp, cfg, x, attend, trace)
            continue
        lp = layer(layers, l)
        xn = rms_norm(lp["norm1"], x, cfg.norm_eps)
        a, _, _ = attn.attn_decode_paged(lp["attn"], cfg, xn, pool[:, l, 0],
                                         pool[:, l, 1], page_table, lengths,
                                         flags)
        x = x + a
        x = x + _ffn(lp, cfg, rms_norm(lp["norm2"], x, cfg.norm_eps),
                     flags)[0]
    return x
