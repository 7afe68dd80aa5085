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
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dtype_of, randn_init

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
