"""Training step: gradient accumulation, AdamW, optional int8 gradient
compression (port of ``repro.train.loop``).

``make_train_step`` builds the step the launcher calls:

    step(params, opt_state, batch) -> (params, opt_state, metrics)

as in the reference, with autograd in place of ``jax.value_and_grad`` and
a loop over microbatches in place of ``lax.scan``.  With ``grad_accum ==
1`` the gradients keep each parameter's dtype; with more, they are summed
into float32 zeros and divided, as the reference's are.  The step runs
eagerly, so where the reference streams the optimizer state between tiers
inside a compiled step, the port always takes the reference's host-stage
path: the launcher pages the state in before the step and out after it.
``abstract_train_state`` (shapes without allocation) belongs to the
sharding work and is not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models.zoo import Model
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     tree_leaves, tree_map)
from repro_torch.optim.compression import ef_compress_tree, ef_state_init


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Dict[str, Any]
    step: int = 0


def train_state_init(model: Model, generator: torch.Generator) -> TrainState:
    params = model.init(generator)
    return TrainState(params=params, opt_state=adamw_init(params))


class StepClock:
    """Wall time of each stage of a step.  Each boundary synchronizes the
    card first, so a stage's time holds its own device work and nothing
    of the next stage's."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.times: Dict[str, float] = {}
        self._t = None

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def start(self) -> None:
        self._t = self._now()

    def lap(self, name: str) -> None:
        now = self._now()
        self.times[name] = now - self._t
        self._t = now


def _split_micro(batch: Dict[str, torch.Tensor], n: int):
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"batch of {B} does not split into {n} "
                         "microbatches")
    m = B // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def value_and_grad(model: Model, params, batch):
    """(loss, grads): the gradient of ``model.loss`` w.r.t. every leaf of
    ``params``, in each leaf's dtype; a leaf the loss does not reach gets
    zeros, as under ``jax.value_and_grad``."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss = model.loss(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), _fill(live, iter(grads))


def _fill(live, grads):
    """The grads of ``live``'s leaves, in sorted-key order, back into its
    tree; None (an unreached leaf) becomes zeros."""
    if isinstance(live, dict):
        return {k: _fill(live[k], grads) for k in sorted(live)}
    g = next(grads)
    return torch.zeros_like(live) if g is None else g


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    grad_accum: int = 1,
                    compress_grads: bool = False) -> Callable:
    """Returns step(params, opt_state, batch, clock=None) -> (params,
    opt_state, metrics).  A :class:`StepClock`, when given, times the
    stages ``fwd_bwd``, ``compress`` and ``adamw``."""

    def step(params, opt_state, batch, clock: Optional[StepClock] = None):
        if clock is not None:
            clock.start()
        if grad_accum == 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for micro in _split_micro(batch, grad_accum):
                l, g = value_and_grad(model, params, micro)
                loss = loss + l
                tree_map(lambda acc, x: acc.add_(x), grads, g)
                del g
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
        if clock is not None:
            clock.lap("fwd_bwd")
        if compress_grads:
            grads, new_err = ef_compress_tree(grads, opt_state["ef_err"])
            if clock is not None:
                clock.lap("compress")
        new_params, new_opt, metrics = adamw_update(
            opt_cfg, grads, {k: v for k, v in opt_state.items()
                             if k != "ef_err"}, params)
        if compress_grads:
            new_opt["ef_err"] = new_err
        if clock is not None:
            clock.lap("adamw")
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return step


def opt_state_init(params, compress_grads: bool = False):
    st = adamw_init(params)
    if compress_grads:
        st["ef_err"] = ef_state_init(params)
    return st
