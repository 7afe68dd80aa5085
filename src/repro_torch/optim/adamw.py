"""AdamW with float32 master copies for low-precision params (port of
``repro.optim.adamw``).

The optimizer state is the tensor that outgrows device memory in training
(2-3x the params in float32): the launcher parks it in the LMB tier
between steps (``repro_torch.launch.train``).  Every scalar of the update
(the schedule, ``b1 ** c``, the bias corrections, the clip scale) is a
float32 tensor, as in the reference, never a Python double; the global
norm sums the leaves in the reference's sorted-key order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_map(fn, *trees):
    """``fn`` over the leaves of dict trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree):
    """Leaves in sorted-key order (the order ``jax.tree_util`` flattens a
    dict in)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    return [tree]


def tree_paths(tree, prefix: tuple = ()):
    """The key path of each leaf, in :func:`tree_leaves`' order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in tree_paths(tree[k], prefix + (k,))]
    return [prefix]


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in float32."""
    s = step.float()
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.minimum(warm, cos)


def adamw_init(params: Any) -> Dict[str, Any]:
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
    dev = tree_leaves(params)[0].device
    return {
        "m": tree_map(f32, params),
        "v": tree_map(f32, params),
        "master": tree_map(lambda p: p.detach().float().clone(), params),
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


def _scalars(cfg: AdamWConfig, grads: Any, count: torch.Tensor):
    """(lr, gnorm, clip scale, bias corrections) of the step that takes
    the count to ``count``: float32 tensors on its device.  ``b1`` and
    ``b2`` are filled on the device (``torch.full``), not copied from the
    host, so a CUDA graph can hold the update."""
    lr = schedule(cfg, count)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    c = count.float()
    f32 = lambda x: torch.full((), x, dtype=torch.float32, device=c.device)
    return lr, gnorm, scale, 1 - f32(cfg.b1) ** c, 1 - f32(cfg.b2) ** c


def _leaf_update(cfg, lr, scale, bc1, bc2, g, m, v, master):
    """One leaf's new (m, v, master)."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.float() * scale
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    step_ = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    decay = cfg.weight_decay if master.dim() >= 2 else 0.0
    return m, v, master - lr * (step_ + decay * master)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Any, state: Dict[str, Any],
                 params: Any) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """One step.  Returns (new_params, new_state, metrics); nothing is
    updated in place.  Weight decay applies where ``master.ndim >= 2``, as
    in the reference: with layers stacked [L, ...] that includes every
    per-layer norm scale and bias, and leaves out only the unstacked
    ``final_norm`` scale."""
    count = state["count"] + 1
    lr, gnorm, scale, bc1, bc2 = _scalars(cfg, grads, count)

    def upd(g, m, v, master, p):
        m, v, master = _leaf_update(cfg, lr, scale, bc1, bc2, g, m, v,
                                    master)
        return m, v, master, master.to(p.dtype)

    out = tree_map(upd, grads, state["m"], state["v"], state["master"],
                   params)
    pick = lambda i: tree_map(lambda o: o[i], out)
    return pick(3), {"m": pick(0), "v": pick(1), "master": pick(2),
                     "count": count}, {"lr": lr, "grad_norm": gnorm}


@torch.no_grad()
def adamw_scalars_(cfg: AdamWConfig, grads: Any, count: torch.Tensor):
    """The first part of :func:`adamw_update_`: ``count`` advanced in
    place, then the step's scalars (lr, gnorm, clip scale, bias
    corrections), for :func:`adamw_leaf_`."""
    count.add_(1)
    return _scalars(cfg, grads, count)


@torch.no_grad()
def adamw_leaf_(cfg: AdamWConfig, scalars, g, m, v, master, p) -> None:
    """The rest of :func:`adamw_update_`, one leaf: its new ``m``, ``v``
    and ``master`` computed by :func:`adamw_update`'s expressions, then
    copied into the state's tensors and the param."""
    lr, _, scale, bc1, bc2 = scalars
    new = _leaf_update(cfg, lr, scale, bc1, bc2, g, m, v, master)
    for dst, src in zip((m, v, master), new):
        dst.copy_(src)
    p.copy_(master)


def adamw_update_(cfg: AdamWConfig, grads: Any, state: Dict[str, Any],
                  params: Any) -> Dict[str, torch.Tensor]:
    """:func:`adamw_update` in place: ``count`` advances in place
    (:func:`adamw_scalars_`) and each leaf is updated by
    :func:`adamw_leaf_`; returns the metrics.  The values are computed
    first and copied in after (no fused in-place arithmetic), so the
    result is :func:`adamw_update`'s bit for bit; a leaf's temporaries
    are freed before the next leaf's, so no second copy of the state is
    made."""
    scalars = adamw_scalars_(cfg, grads, state["count"])
    tree_map(lambda g, m, v, master, p: adamw_leaf_(cfg, scalars, g, m, v,
                                                    master, p),
             grads, state["m"], state["v"], state["master"], params)
    return {"lr": scalars[0], "grad_norm": scalars[1]}
