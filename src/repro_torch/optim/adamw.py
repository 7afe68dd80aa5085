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


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Any, state: Dict[str, Any],
                 params: Any) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """One step.  Returns (new_params, new_state, metrics); nothing is
    updated in place.  Weight decay applies where ``master.ndim >= 2``, as
    in the reference: with layers stacked [L, ...] that includes every
    per-layer norm scale and bias, and leaves out only the unstacked
    ``final_norm`` scale."""
    count = state["count"] + 1
    lr = schedule(cfg, count)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    c = count.float()
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=c.device)
    bc1 = 1 - f32(b1) ** c
    bc2 = 1 - f32(b2) ** c

    def upd(g, m, v, master, p):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        step_ = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        decay = cfg.weight_decay if master.dim() >= 2 else 0.0
        master = master - lr * (step_ + decay * master)
        return m, v, master, master.to(p.dtype)

    out = tree_map(lambda *t: upd(*t), grads, state["m"], state["v"],
                   state["master"], params)
    pick = lambda i: tree_map(lambda o: o[i], out)
    return pick(3), {"m": pick(0), "v": pick(1), "master": pick(2),
                     "count": count}, {"lr": lr, "grad_norm": gnorm}
