"""Scan helpers (port of ``repro.models.scan_utils``).

The reference folds a layer stack into one ``lax.scan`` so that XLA
compiles its body once, and unrolls it in Python for the dry run's cost
analysis.  The port needs no scan: its models loop over layers in Python,
and a CUDA graph captures that loop (the staged steps record every
layer's kernels once and replay them), so both values of ``unroll`` run
the same loop and give the same result.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_map


def scan_layers(body: Callable, carry: Any, xs: Any,
                unroll: bool = False) -> Tuple[Any, Any]:
    """Like ``jax.lax.scan(body, carry, xs)``: ``body(carry, x_i)`` returns
    ``(carry, y_i)`` for each slice ``x_i`` of ``xs``'s leading axis;
    returns the last carry and the ``y_i`` stacked (None when the body
    returns None).  ``unroll`` is accepted and changes nothing."""
    n = tree_leaves(xs)[0].shape[0]
    ys = []
    for i in range(n):
        carry, y = body(carry, tree_map(lambda a: a[i], xs))
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, tree_map(lambda *zs: torch.stack(zs), ys[0], *ys[1:])
