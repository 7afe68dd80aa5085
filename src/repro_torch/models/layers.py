"""Shared layers: norms, embeddings, RoPE, MLPs (port of repro.models.layers).

Conventions, as in the reference:
  * parameters are plain nested dicts of tensors;
  * activations flow in ``cfg.dtype`` (bf16 in production), softmax/norm
    statistics in float32;
  * every init function takes an explicit ``torch.Generator`` and a device
    and returns the param subtree.

Sharding constraints (``constrain``) are no-ops without a mesh in the
reference, so the port drops them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ----------------------------------------------------------------- norms
def rms_norm_init(d: int, device=None, n: Optional[int] = None) -> Params:
    shape = (d,) if n is None else (n, d)
    return {"scale": torch.ones(shape, dtype=torch.float32, device=device)}


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(dt)


# ------------------------------------------------------------- linear init
def randn_init(gen: torch.Generator, shape, std: float,
               dtype) -> torch.Tensor:
    """``randn(shape) * std`` in ``dtype`` on ``gen``'s device, drawn one
    trailing 2-D matrix at a time into the result: a stacked leaf (dbrx's
    experts, [L, E, D, F]) never needs a float32 temporary of its size."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    mats = out.view(-1, *shape[-2:]) if len(shape) > 2 else out[None]
    for m in mats:
        m.copy_(torch.randn(m.shape, generator=gen, dtype=torch.float32,
                            device=gen.device) * std)
    return out


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               bias: bool = False, scale: Optional[float] = None,
               n: Optional[int] = None) -> Params:
    """``n`` stacks ``n`` independent layers on a leading axis."""
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    lead = () if n is None else (n,)
    p = {"w": randn_init(gen, (*lead, d_in, d_out), std, dtype)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=gen.device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# --------------------------------------------------------------- embedding
def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> Params:
    return {"table": randn_init(gen, (vocab, d), 0.02, dtype)}


def embed_lookup(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids.long()]


def embed_logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied readout: x @ table.T (over the padded vocab)."""
    return x @ p["table"].T


# -------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple:
    """positions [*, S] -> (sin, cos) each [*, S, head_dim/2], float32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, hd]; sin/cos [..., S, hd/2] broadcast over heads.
    Each head splits into two halves (not interleaved pairs)."""
    dt = x.dtype
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    s, c = sin[..., None, :], cos[..., None, :]  # add head axis
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dt)


# --------------------------------------------------------------------- MLPs
def mlp_init(gen: torch.Generator, cfg, n: Optional[int] = None) -> Params:
    dt = dtype_of(cfg)
    if cfg.act == "swiglu":
        return {
            "w_gate": dense_init(gen, cfg.d_model, cfg.d_ff, dt, n=n),
            "w_up": dense_init(gen, cfg.d_model, cfg.d_ff, dt, n=n),
            "w_down": dense_init(gen, cfg.d_ff, cfg.d_model, dt, n=n),
        }
    return {
        "w_up": dense_init(gen, cfg.d_model, cfg.d_ff, dt, n=n),
        "w_down": dense_init(gen, cfg.d_ff, cfg.d_model, dt, n=n),
    }


def mlp_apply(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        g = F.silu(dense(p["w_gate"], x))
        return dense(p["w_down"], g * dense(p["w_up"], x))
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(dense(p["w_up"], x), approximate="tanh")
    return dense(p["w_down"], h)


# --------------------------------------------------- chunked cross-entropy
def chunked_softmax_xent(logits_fn, x: torch.Tensor, labels: torch.Tensor,
                         chunk: int = 512, unroll: bool = True
                         ) -> torch.Tensor:
    """Mean token cross-entropy without materializing [B, S, V] at once.

    ``logits_fn(x_chunk) -> [B, c, V]``; the sequence axis is processed in
    chunks of ``chunk`` tokens (``S % chunk == 0``), each chunk's logits in
    float32, so peak memory is O(B * chunk * V).  ``unroll`` chose between
    a Python loop and ``lax.scan`` in the reference; the port always loops,
    so it is accepted and ignored.
    """
    B, S, _ = x.shape
    assert S % chunk == 0, (S, chunk)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, S, chunk):
        logits = logits_fn(x[:, lo:lo + chunk]).float()        # [B, c, V]
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels[:, lo:lo + chunk, None].long())[..., 0]
        total = total + torch.sum(logz - gold)
    return total / (B * S)
