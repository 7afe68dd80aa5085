"""Multi-pod dry run: trace every (arch × shape × mesh) cell without a
device (port of ``repro.launch.dryrun``).

For each cell this builds the right step function (train_4k -> the train
step; prefill_32k -> prefill; decode_32k / long_500k -> one-token
decode), places its parameters, optimizer state, caches and batch as
DTensors by the sharding rules on a fake mesh of 256 or 512 ranks
(``launch/mesh.py``), and runs it under ``FakeTensorMode``: nothing is
allocated and nothing is launched.  A dispatch mode sees every op DTensor
runs on this rank's local shards and records, per device:

  * argument and output bytes (local shard ``nbytes``) and the peak bytes
    the step holds beyond its arguments, at the CUDA allocator's 512-byte
    granularity — the reference's ``memory_analysis()``;
  * matmul FLOPs (``torch.utils.flop_counter``'s formulas) and bytes read
    and written per op — the reference's ``cost_analysis()``.  The bytes
    are unfused eager traffic, more than XLA's fused "bytes accessed";
  * the collectives DTensor issues (``_c10d_functional``), as (kind,
    result bytes) records weighted by ``roofline._TRAFFIC_FACTOR``.

The port loops over layers and chunks in Python, so the counters see
every layer the step runs and the full-depth count is the total; the
per-layer body of the table is cost(L=2) - cost(L=1).  Where the
reference lowers its XLA path, the step runs with ``use_kernels=False``.

Results append to a JSON table (``--out``); already-done cells are skipped
so the sweep is resumable.  Usage:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape decode_32k --mesh single          # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
import weakref
from typing import Any, Dict

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig,
                                      get_config, list_configs)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.flags import Flags
from repro_torch.models.zoo import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.roofline.analysis import (collective_bytes_per_device,
                                           model_flops, roofline_terms)
from repro_torch.roofline.chips import H100_SXM, Chip
from repro_torch.sharding.constraints import activation_mesh
from repro_torch.sharding.partition import (batch_spec, cache_shardings,
                                            param_shardings, placements,
                                            shard_shape)
from repro_torch.train.loop import abstract_train_state, make_train_step

#: the dry run lowers the XLA path, as the reference's does
DRY_FLAGS = Flags(use_kernels=False)

#: the collectives DTensor issues, by name, and the reference's kind; any
#: other op of their namespaces but those that move no data is an error
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_WRAPPERS = ("_wrap_tensor_autograd",)
_COLLECTIVE_NS = ("_c10d_functional", "_dtensor")
#: ops that overwrite their first argument without reading it
_WRITE_ONLY = ("copy_", "fill_", "zero_", "index_put_", "_index_put_impl_")
#: the CUDA caching allocator's granularity
_BLOCK = 512


def _leaves(tree):
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in _leaves(t)]
    return [tree]


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _stride(shape) -> tuple:
    """A contiguous tensor's strides."""
    out, n = [], 1
    for d in reversed(shape):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a view reaches (broadcast dims,
    stride 0, count once)."""
    return math.prod(s for s, st in zip(t.shape, t.stride()) if st) * \
        t.element_size()


def local_nbytes(tree) -> int:
    """Sum of this rank's local ``nbytes`` over a tree's tensors, each
    storage once."""
    from torch.distributed.tensor import DTensor
    seen = WeakIdKeyDictionary()
    for leaf in _leaves(tree):
        if isinstance(leaf, DTensor):
            leaf = leaf._local_tensor
        if isinstance(leaf, torch.Tensor):
            seen[leaf.untyped_storage()] = leaf.untyped_storage().nbytes()
    return sum(seen.values())


def _internal_caller() -> bool:
    """Whether the op being dispatched was called from inside
    ``torch.distributed`` (DTensor's own index arithmetic) rather than
    from the step's code."""
    f = sys._getframe(2)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("torch.distributed"):
            return True
        if mod.startswith("repro_torch"):
            return False
        f = f.f_back
    return False


class StepCounter(TorchDispatchMode):
    """Counts the ops a step runs on this rank's local tensors.

    The step's tensors are fakes of ``fake_mode``.  A DTensor op is handed
    on to DTensor (``NotImplemented``), which runs it as ops on local
    shards that come back here.  Exactly the ops whose outputs are fakes
    of ``fake_mode`` are counted: DTensor's sharding propagation runs its
    shape inference on fakes of a mode of its own, and its index
    arithmetic on small real tensors.  A factory op the step's code calls
    (``torch.zeros``, ``torch.arange``, ...) is made a fake of
    ``fake_mode``, so nothing of the step's size is allocated."""

    def __init__(self, fake_mode):
        super().__init__()
        self.fake = fake_mode
        self.flops = 0
        self.bytes = 0
        self.collectives: list = []
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._known = WeakIdKeyDictionary()

    def know(self, tree) -> None:
        """Storages that exist before the step (its arguments): neither
        new nor freed by it."""
        from torch.distributed.tensor import DTensor
        for leaf in _leaves(tree):
            if isinstance(leaf, DTensor):
                leaf = leaf._local_tensor
            if isinstance(leaf, torch.Tensor):
                self._known[leaf.untyped_storage()] = 0

    def _alloc(self, st) -> None:
        n = -(-st.nbytes() // _BLOCK) * _BLOCK
        self._known[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def _ours(self, t) -> bool:
        return getattr(t, "fake_mode", None) is self.fake

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        name = func._overloadpacket.__name__
        ins = [a for a in _leaves((list(args), kwargs))
               if isinstance(a, torch.Tensor)]
        if name == "wait_tensor" and self._ours(ins[0]):
            return args[0]      # eager semantics: the tensor itself
        if not ins and not _internal_caller():
            with self.fake:
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        outs = [o for o in _leaves(out if isinstance(out, (list, tuple))
                                   else [out])
                if isinstance(o, torch.Tensor)]
        if not any(self._ours(o) for o in outs):
            return out
        self.ops += 1
        new = [o for o in outs if o.untyped_storage() not in self._known]
        for o in new:
            if o.untyped_storage() not in self._known:   # outputs may share
                self._alloc(o.untyped_storage())
        if func.namespace in _COLLECTIVE_NS:
            if name not in _COLLECTIVE_WRAPPERS:
                if name not in _COLLECTIVES:
                    raise RuntimeError(f"dry run: unaccounted collective "
                                       f"{func}")
                self.collectives.append((_COLLECTIVES[name], sum(
                    o.untyped_storage().nbytes() for o in outs)))
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if not new and not func._schema.is_mutable:
            return out                      # a view: no data moves
        if name.startswith(("empty", "new_empty")):
            return out                      # allocation only
        reads = ins[1:] if name in _WRITE_ONLY else ins
        writes = [args[2]] if name in ("index_put_", "_index_put_impl_") \
            else outs
        self.bytes += sum(_distinct_bytes(t) for t in reads) + \
            sum(_distinct_bytes(t) for t in writes)
        return out


def _plain(dt) -> bool:
    """Placements a local rule can read: Replicate and plain Shard."""
    from torch.distributed.tensor import Replicate, Shard
    return all(type(p) in (Replicate, Shard) for p in dt.placements)


def _sharding(dt, d: int) -> list:
    """Mesh dims that shard tensor dim ``d`` of ``dt``."""
    from torch.distributed.tensor import Shard
    return [m for m, p in enumerate(dt.placements)
            if isinstance(p, Shard) and p.dim == d]


def _local_box(dt):
    """(local shape, global offset) of this rank's shard of ``dt``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return compute_local_shape_and_global_offset(dt.shape, dt.device_mesh,
                                                 dt.placements)


def _masked_setitem(dst, idx, src) -> bool:
    """``dst[idx] = src`` where ints or slices index dims of ``dst`` that
    are sharded: each rank writes the part of the range its shard holds,
    and no data moves but what ``src`` needs to line up (the SPMD masked
    update XLA does for a cache slot).  DTensor alone would gather the
    whole sharded dim, write into the copy, and lose the write.  Returns
    False where the rule does not apply (DTensor then runs it)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(dst, DTensor) or not _plain(dst):
        return False
    idx = idx if isinstance(idx, tuple) else (idx,)
    if any(e is Ellipsis or not isinstance(e, (int, slice)) for e in idx):
        return False
    idx = idx + (slice(None),) * (dst.dim() - len(idx))
    full = [isinstance(e, slice) and e.indices(n) == (0, n, 1)
            for e, n in zip(idx, dst.shape)]
    if all(f or not _sharding(dst, d) for d, f in enumerate(full)):
        return False
    if isinstance(src, torch.Tensor) and src.requires_grad and \
            torch.is_grad_enabled():
        return False
    lshape, off = _local_box(dst)
    local_idx, ranges, src_dim = [], [], {}
    for d, (e, n) in enumerate(zip(idx, dst.shape)):
        lo_l, hi_l = off[d], off[d] + lshape[d]
        if isinstance(e, int):
            i = e % n
            if not lo_l <= i < hi_l:
                return True             # another rank holds it
            local_idx.append(i - lo_l)
            continue
        a, b, step = e.indices(n)
        if step != 1:
            return False
        lo, hi = max(a, lo_l), min(b, hi_l)
        if lo >= hi:
            return True
        local_idx.append(slice(lo - lo_l, hi - lo_l))
        src_dim[d] = len(ranges)
        ranges.append((lo - a, hi - a))
    target = dst._local_tensor
    if not isinstance(src, torch.Tensor):
        target[tuple(local_idx)] = src
        return True
    if isinstance(src, DTensor):
        want = []
        for m, p in enumerate(dst.placements):
            q = src.placements[m]
            keep = (isinstance(p, Shard) and full[p.dim]
                    and type(q) is Shard and q.dim == src_dim[p.dim])
            want.append(q if keep else Replicate())
        if list(src.placements) != want:
            src = src.redistribute(src.device_mesh, want)
        kept = {src_dim[p.dim] for p in want if isinstance(p, Shard)}
        src = src._local_tensor
    else:
        kept = set()
    lead = src.dim() - len(ranges)      # src may broadcast over leading dims
    part = src[(slice(None),) * max(lead, 0) + tuple(
        slice(None) if k in kept or src.shape[lead + k] == 1
        else slice(*r) for k, r in enumerate(ranges) if lead + k >= 0)]
    target[tuple(local_idx)] = part
    return True


def _vocab_local(dt, ids, dim: int):
    """This rank's slice of ``dt`` along its sharded ``dim``: (local ids,
    in-range mask)."""
    lshape, off = _local_box(dt)
    li = ids.long() - off[dim]
    inr = (li >= 0) & (li < lshape[dim])
    return torch.where(inr, li, 0), inr


def _ids_like(ids, dt, shard_dims):
    """``ids`` as local data laid out like ``dt`` on every mesh dim but
    ``shard_dims`` (replicated there)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(ids, DTensor):
        return None
    want = [Replicate() if m in shard_dims else p
            for m, p in enumerate(ids.placements)]
    if list(ids.placements) != want:
        ids = ids.redistribute(ids.device_mesh, want)
    return ids


def _vocab_lookup(table, ids):
    """``table[ids]`` on a table sharded over its rows (the vocab): each
    rank looks up the ids its rows hold, zeros elsewhere, and the result
    is a partial sum over the vocab axes — an all-reduce of the looked-up
    rows where XLA's SPMD gather puts it, not a gather of the table."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    if not isinstance(table, DTensor) or not isinstance(ids, DTensor) or \
            ids.dtype.is_floating_point or not _plain(table) or \
            not _plain(ids) or table.dim() != 2:
        return None
    vs = _sharding(table, 0)
    if not vs:
        return None
    ids = _ids_like(ids, table, vs)
    li, inr = _vocab_local(table, ids.to_local(), 0)
    rows = table.to_local()[li] * inr[..., None].to(table.dtype)
    pl = [Partial() if m in vs else
          Shard(ids.dim()) if isinstance(p, Shard) else ids.placements[m]
          for m, p in enumerate(table.placements)]
    shape = (*ids.shape, table.shape[1])
    return DTensor.from_local(rows, table.device_mesh, pl, run_check=False,
                              shape=shape, stride=_stride(shape))


def _vocab_gather(x, dim, index):
    """``torch.gather(x, dim, index)`` along a dim of ``x`` that is
    sharded (the loss's gold logit over a vocab-sharded readout): a local
    gather of the ids each rank holds and a partial sum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(x, DTensor) or not isinstance(index, DTensor) or \
            not _plain(x):
        return None
    dim = dim % x.dim()
    vs = _sharding(x, dim)
    if not vs:
        return None
    want = [Replicate() if m in vs else p for m, p in enumerate(x.placements)]
    if list(index.placements) != want:
        index = index.redistribute(index.device_mesh, want)
    li, inr = _vocab_local(x, index.to_local(), dim)
    g = torch.gather(x.to_local(), dim, li).masked_fill(~inr, 0)
    pl = [Partial() if m in vs else p for m, p in enumerate(x.placements)]
    return DTensor.from_local(g, x.device_mesh, pl, run_check=False,
                              shape=index.shape,
                              stride=_stride(index.shape))


def _sharded_softmax(x, dim, dtype=None):
    """``torch.softmax(x, dim)`` along a dim of ``x`` that is sharded (the
    scores over a sequence-sharded cache): a local max and sum, each
    all-reduced, and a local exp and divide, as XLA's SPMD softmax does.
    DTensor alone gathers the whole dim first."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(x, DTensor) or not _plain(x) or dtype is not None \
            or (x.requires_grad and torch.is_grad_enabled()):
        return None
    dim = dim % x.dim()
    vs = _sharding(x, dim)
    if math.prod(x.device_mesh.size(m) for m in vs) == 1:
        return None                     # one shard holds the whole dim
    mesh, shape = x.device_mesh, x.shape[:dim] + (1,) + x.shape[dim + 1:]
    whole = [Replicate() if m in vs else p for m, p in enumerate(x.placements)]

    def all_reduce(t, op):
        pl = [Partial(op) if m in vs else p for m, p in enumerate(whole)]
        return DTensor.from_local(t, mesh, pl, run_check=False, shape=shape,
                                  stride=_stride(shape)) \
            .redistribute(mesh, whole).to_local()

    local = x.to_local()
    e = torch.exp(local - all_reduce(local.amax(dim, keepdim=True), "max"))
    p = e / all_reduce(e.sum(dim, keepdim=True), "sum")
    return DTensor.from_local(p, mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def _folded_matmul(x, w):
    """``x @ w`` for a DTensor ``x`` of three or more dims whose strides
    do not fold its leading dims into one (a size-1 dim of a permuted
    einsum output), against a 2-d ``w``.  Eager ``matmul`` then runs
    ``bmm`` on ``w`` expanded over the batch, a view on a device, which
    DTensor's redistribution of the batch can materialise, a copy of
    ``w`` a sequence.  The rule flattens ``x``'s leading dims instead, and
    the product is one ``mm``."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or not isinstance(w, DTensor) or \
            x.dim() < 3 or w.dim() != 2:
        return None
    sh, st = x.shape, x.stride()
    if all(st[i] == st[i + 1] * sh[i + 1] for i in range(x.dim() - 2)):
        return None
    return (x.flatten(0, -2) @ w).unflatten(0, x.shape[:-1])


class ShardedRules(TorchFunctionMode):
    """The dry run's rules for ops that DTensor shards badly: a write into
    a slot of a sharded dim (:func:`_masked_setitem`), a vocab-sharded
    lookup (:func:`_vocab_lookup`), a gather along a sharded dim
    (:func:`_vocab_gather`), a softmax along one
    (:func:`_sharded_softmax`) and a matmul that does not fold
    (:func:`_folded_matmul`).  Each use is counted in ``rewrites``; the
    collectives a rule needs are issued as DTensor redistributions, so the
    step counter records them like any other."""

    def __init__(self):
        super().__init__()
        self.rewrites: Dict[str, int] = {}

    def _note(self, kind: str) -> None:
        self.rewrites[kind] = self.rewrites.get(kind, 0) + 1

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.__setitem__:
            if _masked_setitem(*args):
                self._note("masked_write")
                return None
        elif func is torch.Tensor.__getitem__:
            out = _vocab_lookup(*args)
            if out is not None:
                self._note("vocab_lookup")
                return out
        elif func in (torch.gather, torch.Tensor.gather) and not kwargs:
            out = _vocab_gather(*args)
            if out is not None:
                self._note("vocab_gather")
                return out
        elif func in (torch.matmul, torch.Tensor.matmul,
                      torch.Tensor.__matmul__) and not kwargs:
            out = _folded_matmul(*args)
            if out is not None:
                self._note("folded_matmul")
                return out
        elif func in (torch.softmax, torch.Tensor.softmax):
            out = _sharded_softmax(*args, **kwargs)
            if out is not None:
                self._note("sharded_softmax")
                return out
        return func(*args, **kwargs)


def opt_state_shardings(opt_shapes, mesh, cfg, fsdp=False):
    """m/v/master shard like params; scalars replicated."""
    out = {}
    for key, sub in opt_shapes.items():
        if key in ("m", "v", "master", "ef_err"):
            out[key] = param_shardings(sub, mesh, cfg, fsdp=fsdp)
        else:
            out[key] = _map(lambda _: (), sub)
    return out


def _want_fsdp(cfg, shape, chip: Chip = H100_SXM) -> bool:
    """ZeRO/FSDP when the per-device state wouldn't fit HBM otherwise.

    train: params/grads/opt = ~16 B/param, sharded 16-way TP -> FSDP when
    that exceeds the chip's threshold (half its HBM).  serve: bf16 params
    only."""
    n = cfg.param_count()
    per_dev = (16.0 if shape.kind == "train" else 2.0) * n / 16
    return per_dev > chip.fsdp_threshold_bytes


def _batch_specs(mesh, B, specs):
    return {k: batch_spec(mesh, B, v.dim() - 1) for k, v in specs.items()}


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
               flags: Flags = DRY_FLAGS, chip: Chip = H100_SXM):
    """Returns (step fn, args as ``meta`` tensor trees, their specs).

    ``fn(*args)`` runs the cell's step on DTensors placed by the specs."""
    model = build_model(cfg, flags, device="cpu")
    fsdp = _want_fsdp(cfg, shape, chip)
    params = model.abstract_params()
    p_spec = param_shardings(params, mesh, cfg, fsdp=fsdp)
    B = shape.global_batch

    if shape.kind == "train":
        params, opt = abstract_train_state(model)
        o_spec = opt_state_shardings(opt, mesh, cfg, fsdp=fsdp)
        step = make_train_step(model, AdamWConfig())
        batch = model.input_specs(shape)
        return step, (params, opt, batch), \
            (p_spec, o_spec, _batch_specs(mesh, B, batch))

    cache = model.cache_specs(shape)
    c_spec = cache_shardings(cache, mesh, cfg, B)
    if shape.kind == "prefill":
        batch = model.input_specs(shape)
        return model.prefill, (params, batch, cache), \
            (p_spec, _batch_specs(mesh, B, batch), c_spec)

    # serve step: one new token against a seq_len KV cache
    tok = model.input_specs(shape)["token"]
    return model.decode_step, (params, cache, tok), \
        (p_spec, c_spec, batch_spec(mesh, B, 1))


def _out_specs(shape: ShapeConfig, specs, mesh) -> tuple:
    """The layout the step's outputs are held to, as the reference's
    ``out_shardings``: the new params and optimizer state as the old; the
    logits batch-sharded and the cache as it came."""
    if shape.kind == "train":
        return specs[0], specs[1], None
    cache = specs[2] if shape.kind == "prefill" else specs[1]
    return batch_spec(mesh, shape.global_batch, 1), cache


def _conform(out, spec, mesh):
    """``out`` redistributed to ``spec`` (a spec tree; None leaves it)."""
    from torch.distributed.tensor import DTensor
    if spec is None:
        return out
    if isinstance(out, tuple):
        return tuple(_conform(o, s, mesh) for o, s in zip(out, spec))
    if isinstance(out, dict):
        return {k: _conform(v, spec.get(k), mesh) for k, v in out.items()}
    if isinstance(out, DTensor):
        want = placements(spec, mesh)
        if list(out.placements) != want:
            return out.redistribute(mesh, want)
    return out


def argument_bytes(args, specs, mesh) -> int:
    """Per-device bytes of ``build_cell``'s arguments, from the specs'
    shard shapes alone (no tracing; ``mesh`` may be a plain mapping)."""
    sizes = []
    for tree, spec in zip(args, specs):
        _map(lambda a, s: sizes.append(
            math.prod(shard_shape(a.shape, s, mesh)) * a.element_size()),
            tree, spec)
    return sum(sizes)


def _place(meta: torch.Tensor, spec, mesh):
    """A DTensor of ``meta``'s shape and dtype placed by ``spec``, over a
    fake local shard (the active ``FakeTensorMode`` makes it).  A 0-d
    integer (a cache's step counter) holds 0, which the step may read."""
    from torch.distributed.tensor import DTensor
    if meta.dim() == 0:
        local = torch.tensor(0, dtype=meta.dtype)
    else:
        local = torch.empty(shard_shape(meta.shape, spec, mesh),
                            dtype=meta.dtype)
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=meta.shape,
                              stride=_stride(meta.shape))


def measure_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
                 flags: Flags = DRY_FLAGS) -> Dict[str, Any]:
    """Trace one step on the fake mesh; per-device {flops, bytes, coll},
    the collective records, memory and the trace time."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.monotonic()
    fn, args, specs = build_cell(cfg, shape, mesh, flags)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    counter = StepCounter(fake)
    with fake:
        dargs = tuple(_map(lambda m, s: _place(m, s, mesh), a, s)
                      for a, s in zip(args, specs))
    counter.know(dargs)
    arg_bytes = local_nbytes(dargs)     # before the step updates its cache
    rules = ShardedRules()
    with implicit_replication(), counter, rules, \
            activation_mesh(mesh if flags.act_constraints else None):
        out = _conform(fn(*dargs), _out_specs(shape, specs, mesh), mesh)
    memory = {"argument_size_in_bytes": arg_bytes,
              "output_size_in_bytes": local_nbytes(out),
              "peak_size_in_bytes": counter.peak}
    del out, dargs
    return {"flops": float(counter.flops), "bytes": float(counter.bytes),
            "coll": collective_bytes_per_device(
                counter.collectives)["total"],
            "collectives": counter.collectives, "ops": counter.ops,
            "rewrites": rules.rewrites,
            "memory": memory, "trace_s": time.monotonic() - t0}


def roofline_of(meas: Dict[str, Any], cfg: ArchConfig, shape: ShapeConfig,
                chips: int):
    """The roofline terms of a :func:`measure_cell` result."""
    cost = {"flops": meas["flops"], "bytes accessed": meas["bytes"]}
    return roofline_terms(cost, meas["collectives"], chips,
                          model_flops(cfg, shape))


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             flags: Flags = DRY_FLAGS, verbose: bool = True
             ) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "flags": dataclasses.asdict(flags), "status": "skipped",
    }
    if shape_name not in cfg.shape_cells():
        rec["reason"] = "long-context N/A for pure full-attention arch"
        return rec
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    chips = mesh.size()
    try:
        # ---- full depth: the port's counters see every layer ----
        art = measure_cell(cfg, shape, mesh, flags)
        rec["memory"] = art["memory"]
        # ---- per-layer body: cost(L=2) - cost(L=1) ----
        one, two = (measure_cell(dataclasses.replace(
            cfg, num_layers=n,
            num_encoder_layers=n if cfg.encoder_decoder else 0),
            shape, mesh, flags) for n in (1, 2))
        body = {k: two[k] - one[k] for k in ("flops", "bytes", "coll")}
        terms = roofline_of(art, cfg, shape, chips)
        rec.update(status="ok", trace_s=round(art["trace_s"], 2),
                   ops=art["ops"], rewrites=art["rewrites"],
                   raw_artifact={k: art[k] for k in ("flops", "bytes",
                                                     "coll")},
                   body_per_layer=body, roofline=terms.row())
        if verbose:
            r = terms
            m = rec["memory"]
            print(f"[{arch} × {shape_name} × {mesh_kind}] OK "
                  f"trace={art['trace_s']:.1f}s "
                  f"compute={r.compute_s*1e3:.2f}ms "
                  f"memory={r.memory_s*1e3:.2f}ms "
                  f"coll={r.collective_s*1e3:.2f}ms "
                  f"dom={r.dominant} "
                  f"MFU@roof={r.roofline_fraction*100:.1f}% "
                  f"useful={r.useful_flops_ratio*100:.0f}% ({r.chip.name})")
            print(f"    mem/device: args={m['argument_size_in_bytes']} B "
                  f"out={m['output_size_in_bytes']} B "
                  f"peak={m['peak_size_in_bytes']} B")
    except Exception as e:
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[{arch} × {shape_name} × {mesh_kind}] FAIL "
                  f"{type(e).__name__}: {e}")
    return rec


def load_table(path: str) -> Dict[str, Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return {}


def cell_key(arch, shape, mesh, tag="base") -> str:
    return f"{arch}|{shape}|{mesh}|{tag}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--tag", default="base")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--causal-skip", action="store_true")
    ap.add_argument("--attn-chunk", type=int, default=512)
    ap.add_argument("--no-remat", action="store_true")
    args = ap.parse_args(argv)

    flags = dataclasses.replace(
        DRY_FLAGS, causal_skip=args.causal_skip, attn_chunk=args.attn_chunk,
        remat=not args.no_remat)
    archs = list_configs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    table = load_table(args.out)
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                key = cell_key(arch, shape, mesh_kind, args.tag)
                if key in table and table[key]["status"] == "ok" \
                        and not args.force:
                    print(f"[{key}] cached")
                    continue
                rec = run_cell(arch, shape, mesh_kind, flags)
                table[key] = rec
                with open(args.out, "w") as f:
                    json.dump(table, f, indent=1)
    ok = sum(1 for r in table.values() if r["status"] == "ok")
    fail = sum(1 for r in table.values() if r["status"] == "fail")
    skip = sum(1 for r in table.values() if r["status"] == "skipped")
    print(f"== dry-run table: {ok} ok / {fail} fail / {skip} skipped(N/A) ==")


if __name__ == "__main__":
    main()
