"""Sharding rules: DP / TP / EP / SP with divisibility fallback (port of
``repro.sharding.partition``, rule for rule).

Strategy (mesh axes ``("pod",) "data", "model"``):

  * **DP** — batch over ``(pod, data)``; gradients all-reduce over it.
  * **TP (megatron)** — attention Q heads and FFN hidden column-parallel on
    ``model``; output projections row-parallel (psum).  GQA KV projections
    replicate when ``kv_heads % model_size != 0`` (the standard GQA-TP
    choice — KV projections are small).
  * **EP** — MoE expert axis on ``model`` when ``E % model_size == 0``
    (dbrx 16e); otherwise per-expert FFN hidden TP (mixtral 8e).
  * **SP (decode)** — KV-cache sequence dim on ``model`` (KV heads rarely
    divide 16); for ``long_500k`` (batch=1) the cache seq dim also takes
    ``data`` so the data axis isn't idle.

A spec is the port's own small type: a tuple with one entry per tensor
dim, each ``None`` (replicated), a mesh axis name, or a tuple of names
(that dim split over their product, the first name major).  Rules read
axis sizes by name, so ``mesh`` is a ``DeviceMesh`` with named dims or a
plain ``{name: size}`` mapping; :func:`placements` turns a spec into
DTensor placements on a ``DeviceMesh``.  Every rule is validated against
the actual dim size: a non-divisible axis falls back to replication (e.g.
hymba's 25 heads, qwen2's 12) — recorded by ``spec_report`` so the
dry-run output shows exactly what sharded how.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple, Union

from repro_torch.configs.base import ArchConfig

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

_REPORT: List[Tuple[str, Tuple[int, ...], Spec]] = []


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a mapping, in mesh
    order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh)


def mesh_size(mesh, axis: str) -> int:
    return axis_sizes(mesh).get(axis, 1)


def _axes(ax: Axis) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


def _size(mesh, ax: Axis) -> int:
    return math.prod(mesh_size(mesh, a) for a in _axes(ax))


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def batch_spec(mesh, batch: int, extra_dims: int = 1) -> Spec:
    """Spec for [B, ...] inputs; replicates B if it doesn't divide."""
    ax = batch_axes(mesh)
    if batch % _size(mesh, ax) == 0:
        return (ax, *([None] * extra_dims))
    # try data-only
    if batch % mesh_size(mesh, "data") == 0:
        return ("data", *([None] * extra_dims))
    return (None,) * (extra_dims + 1)


def batch_sharding(mesh, batch: int, extra_dims: int = 1) -> list:
    """The DTensor placements of :func:`batch_spec` on the ``DeviceMesh``
    ``mesh``: what ``distribute_tensor`` takes for a [B, ...] input, as
    the reference's ``NamedSharding`` of the same spec."""
    return placements(batch_spec(mesh, batch, extra_dims), mesh)


def shard_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's local shape of a tensor of ``shape`` under ``spec``
    (every named axis must divide its dim)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for d, ax in zip(shape, spec):
        n = _size(mesh, ax)
        if d % n:
            raise ValueError(f"dim {d} does not split over {ax} ({n})")
        out.append(d // n)
    return tuple(out)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: mesh
    dim ``a`` is ``Shard(d)`` where tensor dim ``d`` names ``a`` and ``a``
    has more than one device, else ``Replicate()`` (one device holds the
    whole dim either way).  A dim over several axes must name them in mesh
    order: DTensor then splits it over the first mesh dim first, which is
    JAX's major-to-minor order for the same tuple."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        axes = _axes(ax)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} are not in mesh order {names}")
        for i in idx:
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return out


def _ok(dim: int, mesh, axis: str) -> bool:
    return dim % mesh_size(mesh, axis) == 0


def _map_with_path(fn, tree, path=()):
    """``fn(path_str, leaf)`` over a dict tree, keys in sorted order (the
    order ``jax.tree_util`` visits a dict in)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], (*path, k))
                for k in sorted(tree)}
    return fn("/".join(str(k) for k in path), tree)


def _spec_for_param(path: str, shape: Tuple[int, ...], mesh,
                    cfg: ArchConfig) -> Spec:
    """Rule table.  ``shape`` includes the stacked [L] leading axis for
    trunk params (path contains 'trunk')."""
    parts = path.split("/")
    is_bias = parts[-1] == "b"
    if parts[-1] in ("w", "b"):   # dense_init nests {"w": ..., "b": ...}
        name = parts[-2]
        parent = parts[-3] if len(parts) > 2 else ""
    else:
        name = parts[-1]
        parent = parts[-2] if len(parts) > 1 else ""
    stacked = "trunk" in path
    core = shape[1:] if stacked else shape
    pre = (None,) if stacked else ()

    def spec(*axes) -> Spec:
        return (*pre, *axes)

    if is_bias:   # biases are tiny: replicate (XLA reshards as needed)
        return spec(*([None] * len(core)))

    ms = mesh_size(mesh, "model")
    H, KV = cfg.num_heads, cfg.num_kv_heads

    # ---- embedding -------------------------------------------------------
    if name == "table":
        V, D = core
        if V % ms == 0:
            return spec("model", None)
        if D % ms == 0:
            return spec(None, "model")
        return spec(None, None)

    # ---- attention -------------------------------------------------------
    if parent in ("attn", "cross"):
        if name == "wq":
            return spec(None, "model") if H % ms == 0 else spec(None, None)
        if name in ("wk", "wv"):
            return spec(None, "model") if KV % ms == 0 else spec(None, None)
        if name == "wo":
            return spec("model", None) if H % ms == 0 else spec(None, None)
        if name == "b":  # qkv biases: tiny, replicate
            return spec(*([None] * len(core)))

    # ---- dense / moe FFN ---------------------------------------------------
    if name in ("w_gate", "w_up"):
        if len(core) == 3:  # MoE [E, D, F]
            E, D, F = core
            if E % ms == 0:
                return spec("model", None, None)
            if F % ms == 0:
                return spec(None, None, "model")
            return spec(None, None, None)
        D, F = core
        return spec(None, "model") if F % ms == 0 else spec(None, None)
    if name == "w_down":
        if len(core) == 3:  # MoE [E, F, D]
            E, F, D = core
            if E % ms == 0:
                return spec("model", None, None)
            if F % ms == 0:
                return spec(None, "model", None)
            return spec(None, None, None)
        F, D = core
        return spec("model", None) if F % ms == 0 else spec(None, None)
    if name == "router":
        return spec(None, None)

    # ---- rwkv ----------------------------------------------------------------
    if parent == "rwkv":
        Hr = cfg.d_model // cfg.rwkv_head_dim
        col_ok = Hr % ms == 0
        if name in ("wr", "wk", "wv", "wg"):
            return spec(None, "model") if col_ok else spec(None, None)
        if name == "wo":
            return spec("model", None) if col_ok else spec(None, None)
        if name == "cm_k":
            return spec(None, "model") if core[1] % ms == 0 else spec(None, None)
        if name == "cm_v":
            return spec("model", None) if core[0] % ms == 0 else spec(None, None)
        if name == "cm_r":
            return spec(None, "model") if core[1] % ms == 0 else spec(None, None)
        if name in ("decay_A",):
            return spec(None, None)
        if name == "decay_B":
            return spec(None, "model") if core[1] % ms == 0 else spec(None, None)
        if name == "bonus_u":
            return spec(*([None] * len(core)))

    # ---- ssm (hybrid) ----------------------------------------------------------
    if parent == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        if name == "in_proj":
            return spec(None, "model") if (2 * d_in) % ms == 0 \
                else spec(None, None)
        if name == "out_proj":
            return spec("model", None) if d_in % ms == 0 else spec(None, None)
        if name in ("bc_proj", "dt_proj"):
            # small N/H outputs; keep input dim sharded to match conv output
            return spec(None, None)
        if name in ("conv_w", "conv_b", "A_log", "D_skip"):
            return spec(*([None] * len(core)))

    # ---- norms / scalars: replicate -----------------------------------------
    return spec(*([None] * len(core)))


def param_shardings(param_shapes: Any, mesh, cfg: ArchConfig,
                    report: bool = False, fsdp: bool = False) -> Any:
    """Tree of specs matching a (possibly abstract) param tree.

    ``fsdp=True`` additionally shards the largest still-unsharded dim of
    every >=2-d param over the batch axes (ZeRO-3 / FSDP): per-device
    state shrinks by |data|x at the cost of per-layer weight all-gathers
    (which overlap with compute on real hardware)."""
    _REPORT.clear()
    bat = batch_axes(mesh)

    def f(p, leaf):
        shape = tuple(leaf.shape)
        spec = _spec_for_param(p, shape, mesh, cfg)
        # final validation: every named axis must divide
        fixed = []
        for dim, ax in zip(shape, spec + (None,) * len(shape)):
            fixed.append(None if ax is None or dim % _size(mesh, ax)
                         else ax)
        if fsdp and len(shape) >= 2:
            nbat = _size(mesh, bat)
            # biggest unsharded dim that divides; skip tiny tensors
            cands = sorted(
                (i for i, (d, ax) in enumerate(zip(shape, fixed))
                 if ax is None and d % nbat == 0 and d >= nbat),
                key=lambda i: -shape[i])
            if cands and math.prod(shape) >= 1 << 16:
                fixed[cands[0]] = bat
        spec = tuple(fixed)
        if report:
            _REPORT.append((p, shape, spec))
        return spec

    return _map_with_path(f, param_shapes)


def spec_report() -> List[Tuple[str, Tuple[int, ...], Spec]]:
    return list(_REPORT)


def cache_shardings(cache_shapes: Any, mesh, cfg: ArchConfig,
                    batch: int) -> Any:
    """Decode-cache specs.

    k/v [L,B,C,KV,hd]: B on (pod,)data when divisible, C (seq) on model —
    and on the idle batch axes too when B doesn't shard (long_500k SP).
    rwkv/ssm states: head dim on model, B on data when divisible.
    """
    ms = mesh_size(mesh, "model")
    bax = batch_axes(mesh)
    b_shardable = batch % _size(mesh, bax) == 0
    b = bax if b_shardable else None

    def seq(C: int) -> Axis:
        seq_axes: Tuple[str, ...] = ()
        if C % ms == 0:
            seq_axes = ("model",)
        if not b_shardable and C % (ms * _size(mesh, bax)) == 0:
            seq_axes = (*bax, "model")
        return seq_axes if seq_axes else None

    def f(path, leaf):
        name = path.split("/")[-1]
        shp = tuple(leaf.shape)
        if name in ("k", "v"):          # [L, B, C, KV, hd]
            return (None, b, seq(shp[2]), None, None)
        if name == "pos":               # [B, C]
            return (b, seq(shp[1]))
        if name in ("wkv", "ssm"):      # [L, B, H, N, N] / [L, B, H, P, N]
            return (None, b, "model" if shp[2] % ms == 0 else None,
                    None, None)
        if name in ("tmix_prev", "cmix_prev", "conv"):
            # [L, B, 1, D] / [L, B, K-1, d_in]
            return (None, b, None, "model" if shp[3] % ms == 0 else None)
        if name in ("cross_k", "cross_v"):  # [L, B, S_src, KV, hd]
            return (None, b, "model" if shp[2] % ms == 0 else None,
                    None, None)
        if name == "step":
            return ()
        return (None,) * len(shp)

    return _map_with_path(f, cache_shapes)
