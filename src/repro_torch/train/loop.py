"""Training step: gradient accumulation, AdamW, optional int8 gradient
compression (port of ``repro.train.loop``).

``make_train_step`` builds the reference's step:

    step(params, opt_state, batch) -> (params, opt_state, metrics)

as in the reference, with autograd in place of ``jax.value_and_grad`` and
a loop over microbatches in place of ``lax.scan``.  With ``grad_accum ==
1`` the gradients keep each parameter's dtype; with more, they are summed
into float32 zeros and divided, as the reference's are.  That step runs
eagerly and returns new trees; the launcher pages the state in before it
and out after it (the reference's host-stage path).
``make_train_step_`` is the same step on static buffers, updating params
and state in place and paging a parked state in and out itself, which is
what ``train.staged.StagedTrainStep`` captures as one CUDA graph (the
counterpart of the reference's ``jax.jit(make_train_step(...))``).  It
pages in one of two schedules.  The serial one copies the whole state in
on the current stream, runs the step, and copies it out.  The streamed
one is the counterpart of the reference's in-jit offload mode, where
memory-kind annotations let XLA stream the state between HBM and host
memory around the update: each leaf moves on a device's copy streams,
host to device from the step's start and device to host as soon as it
is updated, beside the forward and backward passes and the update.
``abstract_train_state`` gives the params and the optimizer state as
``meta`` tensors (shapes and dtypes, no storage) for the dry run.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.offload import (CopyStreams, leaf_at, page_in,
                                     page_in_streamed, page_out,
                                     page_out_streamed)
from repro_torch.models.zoo import Model
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_leaf_,
                                     adamw_scalars_, adamw_update,
                                     adamw_update_, tree_leaves, tree_map,
                                     tree_paths)
from repro_torch.optim.compression import (ef_compress_, ef_compress_tree,
                                           ef_compress_tree_, ef_state_init)


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


def _loss_and_grads(model: Model, params, batch, grad_accum: int):
    """The step's loss and gradients: one ``value_and_grad`` in each
    leaf's dtype, or, over ``grad_accum`` microbatches (the loop
    unrolled), float32 sums divided by their count."""
    if grad_accum == 1:
        return value_and_grad(model, params, batch)
    loss = torch.zeros((), dtype=torch.float32,
                       device=tree_leaves(params)[0].device)
    grads = tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    for micro in _split_micro(batch, grad_accum):
        l, g = value_and_grad(model, params, micro)
        loss = loss + l
        tree_map(lambda acc, x: acc.add_(x), grads, g)
        del g
    return loss / grad_accum, tree_map(lambda g: g / grad_accum, grads)


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    grad_accum: int = 1,
                    compress_grads: bool = False) -> Callable:
    """Returns step(params, opt_state, batch, clock=None) -> (params,
    opt_state, metrics).  A :class:`StepClock`, when given, times the
    stages ``fwd_bwd``, ``compress`` and ``adamw``."""

    def step(params, opt_state, batch, clock: Optional[StepClock] = None):
        if clock is not None:
            clock.start()
        loss, grads = _loss_and_grads(model, params, batch, grad_accum)
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


def make_train_step_(model: Model, opt_cfg: AdamWConfig,
                     grad_accum: int = 1, compress_grads: bool = False,
                     streams: Optional[CopyStreams] = None) -> Callable:
    """The step on static buffers, everything in place, as a CUDA graph
    can hold it: returns step_(params, opt_state, batch, out, clock=None)
    -> out.

    ``batch`` holds the static inputs (``tokens`` and ``labels`` [B, S]
    int32; ``src_emb`` for the encoder-decoder), ``out`` the static 0-d
    float32 outputs ``loss``, ``lr`` and ``grad_norm``, written in place.
    ``opt_state`` is the state where it is parked: its pinned host leaves
    are paged to the card for the step and the updated values copied
    back, so their device copies live only while the step runs; leaves
    already on the device (the state kept on the card, or any CPU run)
    are updated where they are.  Params and state are updated in place
    with :func:`adamw_update_` and :func:`ef_compress_tree_` (or their
    per-leaf parts), bit for bit what :func:`make_train_step` computes.
    No value is read on the host.

    Without ``streams`` the page moves run in series with the step on
    the current stream (the serial schedule): :func:`page_in`, the
    forward and backward passes, compression, AdamW, :func:`page_out`.
    A :class:`StepClock`, when given, times ``page_in``, ``fwd_bwd``,
    ``compress``, ``adamw`` and ``page_out``.  With ``streams`` (a
    device's :class:`CopyStreams`) the step streams the state beside its
    compute, as XLA schedules the reference's in-jit offload; see
    :func:`_streamed_step`.  The stages overlap there, so a clock times
    the whole ``step``."""
    if streams is not None:
        return _streamed_step(model, opt_cfg, grad_accum, compress_grads,
                              streams)

    def lap(clock, name):
        if clock is not None:
            clock.lap(name)

    def step_(params, opt_state, batch, out,
              clock: Optional[StepClock] = None):
        if clock is not None:
            clock.start()
        state = page_in(opt_state)
        lap(clock, "page_in")
        loss, grads = _loss_and_grads(model, params, batch, grad_accum)
        lap(clock, "fwd_bwd")
        if compress_grads:
            grads = ef_compress_tree_(grads, state["ef_err"])
            lap(clock, "compress")
        metrics = adamw_update_(opt_cfg, grads, state, params)
        lap(clock, "adamw")
        page_out(state, opt_state)
        lap(clock, "page_out")
        return _outputs(out, loss, metrics["lr"], metrics["grad_norm"])

    return step_


def _outputs(out, loss, lr, grad_norm):
    out["loss"].copy_(loss)
    out["lr"].copy_(lr)
    out["grad_norm"].copy_(grad_norm)
    return out


def _streamed_step(model: Model, opt_cfg: AdamWConfig, grad_accum: int,
                   compress_grads: bool, streams: CopyStreams) -> Callable:
    """:func:`make_train_step_` with the state streamed leaf by leaf on
    ``streams``' two copy streams, ordered by the step's data
    dependencies alone:

    * page-in, on the H2D stream, every copy issued when the step
      starts (beside the forward and backward passes), first what is
      needed first: ``count``, then each ``ef_err`` leaf (compression
      needs them right after the backward pass, and the global norm
      every decompressed gradient before any leaf is updated), then
      each leaf's ``m``, ``v`` and ``master`` in the order the update
      visits them (:func:`tree_paths`);
    * on the current stream, compression of leaf i once its ``ef_err``
      has landed, the scalars (``count`` advanced) once ``count`` has,
      and AdamW of leaf i once its ``m``, ``v`` and ``master`` have;
    * page-out, on the D2H stream, of each leaf as soon as it is
      written: leaf i's ``ef_err`` after its compression, its ``m``,
      ``v`` and ``master`` after its update, ``count`` last;
    * both copy streams joined to the current one before the step
      returns.

    The values are the serial schedule's bit for bit: the same
    expressions, each leaf independent of the others, the global norm
    summed in the same order.  Every device copy of the state is
    allocated on the current stream before the copy streams fork from
    it and lives until they are joined back, so the allocator never
    hands its memory on while a copy is in flight; the peak is the
    serial schedule's (every leaf on the card at once)."""

    def step_(params, opt_state, batch, out,
              clock: Optional[StepClock] = None):
        if clock is not None:
            clock.start()
        paths = tree_paths(params)
        order = ([("count",)] + [("ef_err",) + p for p in paths
                                 if compress_grads]
                 + [(k,) + p for p in paths for k in ("m", "v", "master")])
        state, arrived = page_in_streamed(opt_state, order, streams)
        compute = streams.current()
        loss, grads = _loss_and_grads(model, params, batch, grad_accum)
        if compress_grads:
            dec = {}
            for p in paths:
                streams.wait(compute, arrived[("ef_err",) + p])
                _put(dec, p, ef_compress_(leaf_at(grads, p),
                                          leaf_at(state["ef_err"], p)))
                page_out_streamed(state, opt_state, [("ef_err",) + p],
                                  streams.record(compute), streams)
            grads = dec
        streams.wait(compute, arrived[("count",)])
        scalars = adamw_scalars_(opt_cfg, grads, state["count"])
        for p in paths:
            kinds = [(k,) + p for k in ("m", "v", "master")]
            for path in kinds:
                streams.wait(compute, arrived[path])
            adamw_leaf_(opt_cfg, scalars, leaf_at(grads, p),
                        *(leaf_at(state, path) for path in kinds),
                        leaf_at(params, p))
            page_out_streamed(state, opt_state, kinds,
                              streams.record(compute), streams)
        page_out_streamed(state, opt_state, [("count",)],
                          streams.record(compute), streams)
        streams.join()
        _outputs(out, loss, scalars[0], scalars[1])
        if clock is not None:
            clock.lap("step")
        return out

    return step_


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def opt_state_init(params, compress_grads: bool = False):
    st = adamw_init(params)
    if compress_grads:
        st["ef_err"] = ef_state_init(params)
    return st


def abstract_train_state(model: Model, compress_grads: bool = False):
    """(params, opt_state) as ``meta`` tensors, without allocation."""
    params = model.abstract_params()
    return params, opt_state_init(params, compress_grads)
