"""Gradient compression with error feedback (port of
``repro.optim.compression``).

int8 per-tensor-scaled quantization with an error-feedback residual: the
update applied is ``Q(g + e)`` and ``e' = (g + e) - Q(g + e)``.  On a
multi-host mesh this wraps the data-parallel all-reduce (quantize, reduce,
dequantize); here the quantizer is exact-shape functional, so the training
step exercises the numerics.  ``torch.round`` rounds half to even, as
``jnp.round`` does, so on the same inputs the two packages agree bit for
bit.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.adamw import tree_map


def _quant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def ef_compress(g: torch.Tensor,
                err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (decompressed update in ``g``'s dtype, new error residual
    in float32)."""
    t = g.float() + err
    q, s = _quant_int8(t)
    d = _dequant(q, s)
    return d.to(g.dtype), t - d


def ef_compress_tree(grads: Any, err_tree: Any) -> Tuple[Any, Any]:
    outs = tree_map(ef_compress, grads, err_tree)
    return (tree_map(lambda o: o[0], outs), tree_map(lambda o: o[1], outs))


@torch.no_grad()
def ef_compress_(g: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """:func:`ef_compress` with the residual written into ``err``;
    returns the decompressed update."""
    d, e = ef_compress(g, err)
    err.copy_(e)
    return d


def ef_compress_tree_(grads: Any, err_tree: Any) -> Any:
    """:func:`ef_compress_tree` with the residual in place: each leaf's
    new residual is written into ``err_tree`` (:func:`ef_compress_`), and
    the decompressed updates are returned; the values are
    :func:`ef_compress`'s bit for bit, and a leaf's temporaries are freed
    before the next leaf's.  The gradients are only read: two of
    autograd's may share storage."""
    return tree_map(ef_compress_, grads, err_tree)


def ef_state_init(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
