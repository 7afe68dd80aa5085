"""Mixture-of-Experts FFN: token-choice top-k routing with capacity dispatch
(port of ``repro.models.moe``).

The reference's GShard grouped capacity dispatch, token for token: tokens
split into groups of ``flags.moe_group`` (halved until it divides the token
count), each group routes on its own with capacity
C = ceil(top_k * g * capacity_factor / E), (token, choice) pairs claim an
expert's slots in token-major, choice-minor order, and the pairs past C are
dropped (their token passes on the residual).  Where the reference builds
one-hot dispatch and combine tensors and contracts them, the port scatters
the kept tokens into their slots and gathers the experts' outputs back:
the same slots, the same sums.  The expert products are the reference's
einsums, batched over experts.

dbrx-132b: 16 experts, top-4; mixtral-8x22b: 8 experts, top-2.

:func:`routed_apply` is the other expert layer (``router_score
"sigmoid"``, k-exaone-236b-a23b), which the JAX package does not have:
DeepSeek-V3's router (sigmoid scores in f32 over all ``num_experts``, the
top_k of the scores plus a per-expert selection bias, among the
``topk_group`` of ``n_group`` expert groups whose two best biased scores
sum highest where ``n_group`` > 1, gates the chosen scores normalised
over their sum and scaled by ``routed_scale``), no
capacity and no drops, computed for the ``experts_held`` experts the
layer holds, ids ``first..first+held-1`` (the chip's share of an
expert-parallel deployment; the absent experts' part is left out), plus
the shared experts every token runs.  The held experts' products are
``kernels/expert_ffn.py``'s grouped kernels on the card.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (Params, dense_init, dtype_of,
                                       mlp_apply, randn_init)
from repro_torch.obs.trace import NULL_SPAN

#: tokens per dispatch group when the flags name none (the reference's)
GROUP_TOKENS = 1024


def moe_init(gen: torch.Generator, cfg, n: Optional[int] = None) -> Params:
    """One layer's params (``n`` stacks ``n`` layers on a leading axis).
    The router stays float32, as in the reference."""
    dt = dtype_of(cfg)
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = () if n is None else (n,)
    std = 1.0 / math.sqrt(D)
    return {
        "router": randn_init(gen, (*lead, D, E), 0.02, torch.float32),
        "w_gate": randn_init(gen, (*lead, E, D, Fd), std, dt),
        "w_up": randn_init(gen, (*lead, E, D, Fd), std, dt),
        "w_down": randn_init(gen, (*lead, E, Fd, D), 1.0 / math.sqrt(Fd),
                             dt),
    }


def _top_k_gating(logits: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [..., E] -> (weights [..., k] f32, expert ids [..., k]): the
    k largest in descending order (``jax.lax.top_k``), softmax over them."""
    vals, idx = torch.topk(logits, k, dim=-1, largest=True, sorted=True)
    return torch.softmax(vals.float(), dim=-1), idx


def group_size(T: int, flags=None) -> int:
    """The reference's dispatch group: ``moe_group`` (else
    ``GROUP_TOKENS``) capped at T, halved until it divides T."""
    g = min(getattr(flags, "moe_group", None) or GROUP_TOKENS, T)
    while T % g:
        g //= 2
    return g


def route(p: Params, cfg, xt: torch.Tensor):
    """Routing of grouped tokens xt [G, g, D].

    Returns (logits [G,g,E] f32, weights [G,g,K] f32, ids [G,g,K],
    slot [G,g,K] (the pair's position in its expert's capacity), keep
    [G,g,K] bool (slot < C), C)."""
    E, K = cfg.num_experts, cfg.top_k
    g = xt.shape[1]
    C = int(-(-K * g * cfg.capacity_factor // E))
    logits = xt.float() @ p["router"]                          # [G, g, E]
    weights, ids = _top_k_gating(logits, K)
    onehot = F.one_hot(ids, E)                                 # [G, g, K, E]
    flat = onehot.reshape(xt.shape[0], g * K, E)
    claims = (torch.cumsum(flat, dim=1) - flat).reshape(onehot.shape)
    slot = torch.sum(claims * onehot, dim=-1)                  # [G, g, K]
    return logits, weights, ids, slot, slot < C, C


def moe_apply(p: Params, cfg, x: torch.Tensor,
              flags=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux_loss [] f32)."""
    B, S, D = x.shape
    E = cfg.num_experts
    T = B * S
    g = group_size(T, flags)
    G = T // g
    xt = x.reshape(G, g, D)
    logits, weights, ids, slot, keep, C = route(p, cfg, xt)

    # dispatch: each kept (token, choice) into its expert's slot; unclaimed
    # slots stay zero, as the one-hot dispatch leaves them.  Dropped pairs
    # all land in a spare slot C that is cut off (no boolean indexing, so
    # the host never waits for the card here)
    gi = torch.arange(G, device=x.device)[:, None, None].expand_as(ids)
    xin = x.new_zeros((E, G, C + 1, D))
    xin[ids, gi, torch.where(keep, slot, C)] = \
        xt[:, :, None, :].expand(G, g, cfg.top_k, D)

    # expert compute, batched over experts: [E, G*C, D] x [E, D, F]
    xe = xin[:, :, :C].reshape(E, G * C, D)
    if cfg.act == "swiglu":
        h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    else:
        h = F.gelu(torch.bmm(xe, p["w_up"]), approximate="tanh")
    xout = torch.bmm(h, p["w_down"]).reshape(E, G, C, D)

    # combine: each pair's output weighted by its gate (zero if dropped),
    # the weights cast to the model dtype as the reference's combine is
    comb = (weights * keep).to(x.dtype)                        # [G, g, K]
    picked = xout[ids, gi, torch.where(keep, slot, 0)]         # [G,g,K,D]
    y = torch.sum(comb[..., None] * picked, dim=2).reshape(B, S, D)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    me = torch.mean(torch.softmax(logits, dim=-1), dim=(0, 1))
    ce = torch.mean(F.one_hot(ids[:, :, 0], E).float(), dim=(0, 1))
    return y, E * torch.sum(me * ce)


# ------------------------------------------------- sigmoid-routed experts
def routed_init(gen: torch.Generator, cfg, n: Optional[int] = None) -> Params:
    """One layer's params of :func:`routed_apply` (``n`` stacks ``n``
    layers): the router over all ``num_experts`` and its selection bias in
    float32, the ``experts_held`` experts' matrices, and the shared
    experts' SwiGLU of ``shared_experts * d_ff``."""
    dt = dtype_of(cfg)
    D, Fd, E, Eh = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.experts_held
    lead = () if n is None else (n,)
    std = 1.0 / math.sqrt(D)
    p = {
        "router": randn_init(gen, (*lead, D, E), 0.02, torch.float32),
        "select_bias": torch.zeros((*lead, E), dtype=torch.float32,
                                   device=gen.device),
        "w_gate": randn_init(gen, (*lead, Eh, D, Fd), std, dt),
        "w_up": randn_init(gen, (*lead, Eh, D, Fd), std, dt),
        "w_down": randn_init(gen, (*lead, Eh, Fd, D), 1.0 / math.sqrt(Fd),
                             dt),
    }
    if cfg.shared_experts:
        Fs = cfg.shared_experts * Fd
        p["shared"] = {"w_gate": dense_init(gen, D, Fs, dt, n=n),
                       "w_up": dense_init(gen, D, Fs, dt, n=n),
                       "w_down": dense_init(gen, Fs, D, dt, n=n)}
    return p


def group_limit(b: torch.Tensor, n_group: int,
                topk_group: int) -> torch.Tensor:
    """Biased scores b [T, E] with every expert outside each token's
    ``topk_group`` best of ``n_group`` equal groups set to -inf, a group
    ranked by the sum of its two best scores (DeepSeek-V3's
    ``noaux_tc``)."""
    T, E = b.shape
    g = b.view(T, n_group, E // n_group)
    best = g.topk(2, dim=-1).values.sum(dim=-1)                # [T, groups]
    keep = torch.zeros_like(best, dtype=torch.bool).scatter_(
        1, best.topk(topk_group, dim=-1).indices, True)
    return g.masked_fill(~keep[..., None], float("-inf")).view(T, E)


def route_sigmoid(p: Params, cfg, xt: torch.Tensor):
    """xt [T, D] -> (expert ids [T, K], gates [T, K] f32): the top_k of
    ``sigmoid(xt W_r) + select_bias`` in descending order (among the
    :func:`group_limit` groups where ``cfg.n_group`` > 1), gated by their
    scores (without the bias) over the scores' sum, times
    ``routed_scale``."""
    s = torch.sigmoid(xt.float() @ p["router"])                # [T, E]
    b = s + p["select_bias"]
    if cfg.n_group > 1:
        b = group_limit(b, cfg.n_group, cfg.topk_group)
    ids = torch.topk(b, cfg.top_k, dim=-1).indices
    w = torch.gather(s, 1, ids)
    return ids, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg.routed_scale


def routed_apply(p: Params, cfg, x: torch.Tensor, first: int = 0,
                 trace=None) -> torch.Tensor:
    """x [B, S, D] -> y [B, S, D]: the held experts' (``first`` on)
    part of the routed sum, plus the shared experts if ``p`` has them.
    Dropless, and free of host syncs, so a CUDA graph captures it.  With
    an enabled ``trace`` an eager call records the routing as a
    ``moe.route`` span; a call being captured records none."""
    from repro_torch.kernels import ops as kops
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    on = (trace is not None and trace.enabled
          and not (x.is_cuda and torch.cuda.is_current_stream_capturing()))
    with (trace.span("moe.route", op="moe", tokens=B * S,
                     held=p["w_gate"].shape[0], top_k=cfg.top_k,
                     n_group=cfg.n_group, topk_group=cfg.topk_group)
          if on else NULL_SPAN):
        ids, gates = route_sigmoid(p, cfg, xt)
    y = kops.expert_ffn(xt, ids - first, gates, p["w_gate"], p["w_up"],
                        p["w_down"]).to(x.dtype)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], xt, "swiglu")
    return y.reshape(B, S, D)
