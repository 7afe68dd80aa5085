"""Activation sharding constraints (Megatron-SP style), context-scoped
(port of ``repro.sharding.constraints``).

Sharding propagation can leave large intermediates replicated.  The fix
is standard: pin the key activations —

  residual stream   [B, S, D]  -> (batch, "model", None)   seq-sharded SP
  ffn hidden        [B, S, F]  -> (batch, None, "model")
  attention heads   [B, S, H*hd] -> (batch, None, "model")

Model code calls ``constrain(x, "residual")`` etc.  Without an active
mesh, or on a tensor that is not a DTensor (every eager run), it returns
its input object unchanged.  The dry run activates it with
``activation_mesh(mesh)``; a DTensor is then redistributed to the rule's
placements.  Every constraint validates divisibility and degrades to
fewer/no named axes (hymba's 25 heads etc.).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from repro_torch.sharding.partition import (Spec, batch_axes, mesh_size,
                                            placements)

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "activation_mesh", default=None)


@contextlib.contextmanager
def activation_mesh(mesh):
    tok = _ACTIVE.set(mesh)
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


def _fits(dim: int, mesh, axes) -> bool:
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= mesh_size(mesh, a)
    return dim % n == 0


def constraint_spec(shape, kind: str, mesh) -> Optional[Spec]:
    """The spec ``constrain`` pins a tensor of ``shape`` to, or None where
    it leaves the tensor alone (fewer than two dims)."""
    if len(shape) < 2:
        return None
    B = shape[0]
    bat = batch_axes(mesh)
    b_ax = bat if _fits(B, mesh, bat) else \
        (("data",) if _fits(B, mesh, ("data",)) else None)
    if len(shape) == 2:
        return (b_ax, None)
    S, D = shape[1], shape[-1]
    mid = [None] * (len(shape) - 3)
    if kind == "residual":
        s_ax = "model" if (S > 1 and _fits(S, mesh, "model")) else None
        return (b_ax, s_ax, *mid, None)
    if kind in ("ffn_hidden", "heads"):
        d_ax = "model" if _fits(D, mesh, "model") else None
        return (b_ax, None, *mid, d_ax)
    raise ValueError(kind)


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    mesh = _ACTIVE.get()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = constraint_spec(tuple(x.shape), kind, mesh)
    if spec is None:
        return x
    return x.redistribute(mesh, placements(spec, mesh))
