"""Carry the JAX reference's parameters into the port.

The reference's params are a pytree of nested dicts
(``{"embed": {"table"}, "final_norm": {"scale"}, "trunk": {...}}`` with
[L]-stacked trunk leaves); after ``jax.tree_util.tree_map(np.asarray,
...)`` they are nested dicts of numpy arrays, which this module turns into
the port's params key for key.  It imports neither jax nor ``repro``.
Like every entry point of the port it targets the card unless given
``device="cpu"``, and raises when asked for a card that is not there.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.devices import resolve_device


def tensor_from_numpy(a, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One leaf.  A bfloat16 array (``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses) goes through float32 and comes back as
    ``torch.bfloat16``; every other dtype is kept.  ``dtype``, when
    given, replaces the dtype of every leaf that is not float32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.require(a, requirements=["C", "W"]))
    if dtype is not None and t.dtype != torch.float32:
        t = t.to(dtype)
    return t.to(resolve_device(device))


def params_from_numpy(tree: Dict[str, Any], device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The port's params for the reference's ``tree``, key for key.
    Norm scales stay float32 as in the reference; ``dtype`` recasts the
    model-dtype leaves (see :func:`tensor_from_numpy`)."""
    device = resolve_device(device)
    return {k: (params_from_numpy(v, device, dtype) if isinstance(v, dict)
                else tensor_from_numpy(v, device, dtype))
            for k, v in tree.items()}
