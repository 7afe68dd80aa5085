"""RWKV-6 "Finch": attention-free time-mix with data-dependent decay
(port of ``repro.models.rwkv6``).

Recurrence (per head, head dim N = rwkv_head_dim):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          S in R^{N x N}
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)      (bonus u for current token)

with w_t in (0,1)^N data-dependent (from a token-shifted low-rank MLP).
Prefill runs the whole prompt through ``kernels.ops.rwkv6_scan`` under
``flags.use_kernels`` (the CUDA kernel on the card) or through the chunked
form :func:`wkv_chunked`; decode is one recurrence step on the
[B, H, N, N] state (:func:`wkv_step`, plain torch as in the reference).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain
from repro_torch.models.flags import DEFAULT_FLAGS, Flags
from repro_torch.models.layers import (Params, dense, dense_init, dtype_of,
                                       rms_norm, rms_norm_init)
from repro_torch.sharding.constraints import constrain


def rwkv_init(gen: torch.Generator, cfg, n: Optional[int] = None) -> Params:
    """One layer's params (``n`` stacks ``n`` layers on a leading axis),
    drawn from ``gen`` on its device; the reference's keys, shapes and
    dtypes."""
    dt = dtype_of(cfg)
    D = cfg.d_model
    N = cfg.rwkv_head_dim
    H = D // N
    lora = max(32, D // 64)
    lead = () if n is None else (n,)
    dev = gen.device

    def full(shape, value):
        return torch.full((*lead, *shape), value, dtype=torch.float32,
                          device=dev)

    return {
        # time-mix projections
        "wr": dense_init(gen, D, D, dt, n=n),
        "wk": dense_init(gen, D, D, dt, n=n),
        "wv": dense_init(gen, D, D, dt, n=n),
        "wg": dense_init(gen, D, D, dt, n=n),
        "wo": dense_init(gen, D, D, dt, n=n),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x A) B))
        "decay_w0": full((D,), -6.0),
        "decay_A": dense_init(gen, D, lora, dt, n=n),
        "decay_B": dense_init(gen, lora, D, dt, n=n),
        "bonus_u": full((H, N), 0.0),
        # token-shift mixing coefficients
        "mu_r": full((D,), 0.5),
        "mu_k": full((D,), 0.5),
        "mu_v": full((D,), 0.5),
        "mu_g": full((D,), 0.5),
        "mu_w": full((D,), 0.5),
        "ln_x": rms_norm_init(D, dev, n),
        # channel-mix
        "cm_k": dense_init(gen, D, cfg.d_ff, dt, n=n),
        "cm_v": dense_init(gen, cfg.d_ff, D, dt, n=n),
        "cm_r": dense_init(gen, D, D, dt, n=n),
        "mu_ck": full((D,), 0.5),
        "mu_cr": full((D,), 0.5),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """shifted(x)_t = x_{t-1}; prev [B, 1, D] supplies x_{-1}."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x * mu + xs * (1.0 - mu)


def _rkvwg(p: Params, cfg, x: torch.Tensor, prev: torch.Tensor,
           fuse: bool = False):
    B, S, D = x.shape
    N = cfg.rwkv_head_dim
    H = D // N
    xs = _token_shift(x, prev)
    if fuse:
        # fold mu into the weights: one matmul against x, one against xs
        names = ("wr", "wk", "wv", "wg")
        mus = (p["mu_r"], p["mu_k"], p["mu_v"], p["mu_g"])
        dt = x.dtype
        wx = torch.cat(
            [(mu[:, None] * p[n]["w"].float()).to(dt)
             for n, mu in zip(names, mus)]
            + [(p["mu_w"][:, None] * p["decay_A"]["w"].float()).to(dt)],
            dim=1)
        ws = torch.cat(
            [((1.0 - mu)[:, None] * p[n]["w"].float()).to(dt)
             for n, mu in zip(names, mus)]
            + [((1.0 - p["mu_w"])[:, None]
                * p["decay_A"]["w"].float()).to(dt)],
            dim=1)
        fused = x @ wx + xs.to(dt) @ ws                    # [B,S,4D+lora]
        r, k, v, g, aw = torch.split(
            fused, [D, D, D, D, fused.shape[-1] - 4 * D], dim=-1)
    else:
        r = dense(p["wr"], _mix(x, xs, p["mu_r"]).to(x.dtype))
        k = dense(p["wk"], _mix(x, xs, p["mu_k"]).to(x.dtype))
        v = dense(p["wv"], _mix(x, xs, p["mu_v"]).to(x.dtype))
        g = dense(p["wg"], _mix(x, xs, p["mu_g"]).to(x.dtype))
        xw = _mix(x, xs, p["mu_w"]).to(x.dtype)
        aw = dense(p["decay_A"], xw)
    dec = p["decay_w0"] + torch.tanh(aw.float()) @ p["decay_B"]["w"].float()
    w = torch.exp(-torch.exp(dec))                              # (0,1)^D
    shape = (B, S, H, N)
    # contiguous: the scan kernel takes dense [B,S,H,N] tensors, and the
    # fused projection's split hands out strided views
    return (r.reshape(shape).contiguous(), k.reshape(shape).contiguous(),
            v.reshape(shape).contiguous(), F.silu(g), w.reshape(shape))


#: Chunked WKV6, r,k,v,w [B,S,H,N]; u [H,N]; state [B,H,N,N] -> (out, final
#: state), all f32.  In eager torch the reference's chunked XLA path and the
#: scan kernel's plain version are one computation (its ``unroll`` flag,
#: ``lax.scan`` or a Python loop, has no counterpart: the port loops).
wkv_chunked = rwkv6_scan_plain


def wkv_step(r, k, v, w, u, state):
    """One decode step.  r,k,v,w [B,H,N]; state [B,H,N,N] -> (o, state')."""
    f32 = torch.float32
    r, k, v, w = (a.to(f32) for a in (r, k, v, w))
    kv = torch.einsum("bhn,bhm->bhnm", k, v)
    o = torch.einsum("bhn,bhnm->bhm", r, state + u[None, ..., None] * kv)
    state = state * w[..., None] + kv
    return o, state


def time_mix(p: Params, cfg, x: torch.Tensor, prev_x: torch.Tensor,
             state: torch.Tensor, flags: Flags = DEFAULT_FLAGS,
             decode: bool = False):
    """x [B,S,D]; prev_x [B,1,D]; state [B,H,N,N].

    Returns (out [B,S,D], new_prev_x, new_state)."""
    B, S, D = x.shape
    r, k, v, g, w = _rkvwg(p, cfg, x, prev_x, fuse=flags.fuse_rwkv_proj)
    u = p["bonus_u"]
    if decode:
        o, state = wkv_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, state)
        o = o[:, None]
    elif flags.use_kernels:
        # the kernel route keeps the reference's chunk of 64
        o, state = kops.rwkv6_scan(r, k, v, w, u, state)
    else:
        o, state = wkv_chunked(r, k, v, w, u, state, chunk=flags.scan_chunk)
    o = o.reshape(B, S, D).to(x.dtype)
    o = rms_norm(p["ln_x"], o, cfg.norm_eps) * g
    out = dense(p["wo"], o)
    return out, x[:, -1:], state


def channel_mix(p: Params, cfg, x: torch.Tensor, prev_x: torch.Tensor):
    """RWKV channel-mix (squared-relu FFN with receptance gate)."""
    xs = _token_shift(x, prev_x)
    xk = _mix(x, xs, p["mu_ck"]).to(x.dtype)
    xr = _mix(x, xs, p["mu_cr"]).to(x.dtype)
    h = constrain(torch.square(torch.relu(dense(p["cm_k"], xk))),
                  "ffn_hidden")
    kv = dense(p["cm_v"], h)
    return torch.sigmoid(dense(p["cm_r"], xr)) * kv, x[:, -1:]


def rwkv_state_init(cfg, batch: int, device, dtype=torch.float32) -> Tuple:
    N = cfg.rwkv_head_dim
    H = cfg.d_model // N
    return (torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                        device=device),                   # time-mix shift
            torch.zeros((batch, H, N, N), dtype=torch.float32,
                        device=device),                   # wkv state
            torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                        device=device))                   # channel-mix shift
