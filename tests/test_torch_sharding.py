"""The port's sharding rules against the reference's, spec for spec.

The reference side runs on ``jax.sharding.AbstractMesh`` (no devices);
the port's on plain ``{axis: size}`` shapes, and its placements on a
``DeviceMesh`` over a fake process group (``launch/mesh.py``).  Specs are
compared with single-axis tuples read as the axis (JAX normalises
``P(("data",))`` to ``P("data")``), every other entry as it is.
"""

import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs.base import get_config as jget_config
from repro.configs.base import list_configs
from repro.models import build_model as jbuild_model
from repro.sharding import partition as jpart
from repro.sharding.constraints import activation_mesh as jactivation_mesh
from repro.sharding.constraints import constrain as jconstrain
from repro.train.loop import abstract_train_state as jabstract_train_state
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_mesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.sharding import constraints, partition
from repro_torch.train.loop import abstract_train_state

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _norm(entry):
    if isinstance(entry, tuple):
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


def _spec(spec, ndim):
    return tuple(_norm(e) for e in tuple(spec)) + \
        (None,) * (ndim - len(tuple(spec)))


def _jleaves(tree):
    return [(jax.tree_util.keystr(p, simple=True, separator="/"), l)
            for p, l in jax.tree_util.tree_leaves_with_path(tree)]


def _pleaves(tree, path=()):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _pleaves(tree[k], (*path, k))]
    return [("/".join(path), tree)]


def _compare(jshapes, jshard, pshapes, pspecs, amesh):
    """Leaf for leaf: path, shape, spec, and the local shard shape."""
    jl, pl = _jleaves(jshapes), _pleaves(pshapes)
    js, ps = _jleaves(jshard), _pleaves(pspecs)
    assert [p for p, _ in jl] == [p for p, _ in pl] == \
        [p for p, _ in js] == [p for p, _ in ps]
    sizes = dict(amesh.shape)
    for (path, jleaf), (_, pleaf), (_, ns), (_, spec) in zip(jl, pl, js, ps):
        assert tuple(jleaf.shape) == tuple(pleaf.shape), path
        assert _spec(ns.spec, len(jleaf.shape)) == \
            _spec(spec, len(jleaf.shape)), path
        assert partition.shard_shape(pleaf.shape, spec, sizes) == \
            ns.shard_shape(tuple(jleaf.shape)), path


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_configs())
def test_param_opt_cache_and_batch_specs_match_the_reference(arch,
                                                              mesh_name):
    shape, names = MESHES[mesh_name]
    amesh = AbstractMesh(shape, names)
    sizes = dict(zip(names, shape))
    jmodel, model = jbuild_model(jget_config(arch)), \
        build_model(get_config(arch), device="cpu")
    jcfg, cfg = jmodel.cfg, model.cfg
    jparams, jopt = jabstract_train_state(jmodel, compress_grads=True)
    params, opt = abstract_train_state(model, compress_grads=True)
    for fsdp in (False, True):
        _compare(jparams, jpart.param_shardings(jparams, amesh, jcfg,
                                                fsdp=fsdp),
                 params, partition.param_shardings(params, sizes, cfg,
                                                   fsdp=fsdp), amesh)
        for key in ("m", "v", "master", "ef_err"):
            _compare(jopt[key], jpart.param_shardings(jopt[key], amesh,
                                                      jcfg, fsdp=fsdp),
                     opt[key], partition.param_shardings(opt[key], sizes,
                                                         cfg, fsdp=fsdp),
                     amesh)
    assert tuple(jopt["count"].shape) == tuple(opt["count"].shape) == ()
    # the dry run's optimizer specs: m, v, master, ef_err as the params,
    # the step count replicated
    o_spec = dryrun.opt_state_shardings(opt, sizes, cfg)
    assert o_spec["count"] == () and o_spec["m"] == o_spec["ef_err"] == \
        partition.param_shardings(params, sizes, cfg)
    for name in cfg.shape_cells():
        B = SHAPES[name].global_batch
        jc, c = jmodel.cache_specs(name), model.cache_specs(name)
        _compare(jc, jpart.cache_shardings(jc, amesh, jcfg, B),
                 c, partition.cache_shardings(c, sizes, cfg, B), amesh)
    for B in (1, 3, 32, 128, 256):
        for extra in (1, 2):
            assert _spec(jpart.batch_spec(amesh, B, extra), extra + 1) == \
                _spec(partition.batch_spec(sizes, B, extra), extra + 1)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "hymba-1.5b",
                                  "mixtral-8x22b"])
def test_spec_report_matches_the_reference(arch):
    amesh = AbstractMesh((16, 16), ("data", "model"))
    jmodel = jbuild_model(jget_config(arch))
    model = build_model(get_config(arch), device="cpu")
    jpart.param_shardings(jmodel.abstract_params(), amesh, jmodel.cfg,
                          report=True, fsdp=True)
    partition.param_shardings(model.abstract_params(),
                              {"data": 16, "model": 16}, model.cfg,
                              report=True, fsdp=True)
    jrep, rep = jpart.spec_report(), partition.spec_report()
    assert [(p, s) for p, s, _ in jrep] == [(p, s) for p, s, _ in rep]
    assert [_spec(a, len(s)) for _, s, a in jrep] == \
        [_spec(b, len(s)) for _, s, b in rep]
    partition.param_shardings(model.abstract_params(),
                              {"data": 16, "model": 16}, model.cfg)
    assert partition.spec_report() == []


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
def test_placements_give_the_reference_shard_shapes(mesh_name):
    """DTensor's local shapes on the fake mesh, from ``placements``, are
    ``NamedSharding.shard_shape`` for every param and cache leaf."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, names = MESHES[mesh_name]
    amesh = AbstractMesh(shape, names)
    mesh = fake_mesh(shape, names)
    for arch in ("qwen2-1.5b", "dbrx-132b", "rwkv6-7b", "hymba-1.5b",
                 "seamless-m4t-large-v2"):
        jmodel = jbuild_model(jget_config(arch))
        model = build_model(get_config(arch), device="cpu")
        for jtree, tree, jsh, sh in (
                (jmodel.abstract_params(), model.abstract_params(),
                 lambda t: jpart.param_shardings(t, amesh, jmodel.cfg,
                                                 fsdp=True),
                 lambda t: partition.param_shardings(t, mesh, model.cfg,
                                                     fsdp=True)),
                (jmodel.cache_specs("long_500k"),
                 model.cache_specs("long_500k"),
                 lambda t: jpart.cache_shardings(t, amesh, jmodel.cfg, 1),
                 lambda t: partition.cache_shardings(t, mesh, model.cfg,
                                                     1))):
            for (_, jl), (_, ns), (_, pl), (_, spec) in zip(
                    _jleaves(jtree), _jleaves(jsh(jtree)), _pleaves(tree),
                    _pleaves(sh(tree))):
                local, _ = compute_local_shape_and_global_offset(
                    tuple(pl.shape), mesh,
                    partition.placements(spec, mesh))
                assert tuple(local) == ns.shard_shape(tuple(jl.shape))


def test_a_dim_over_pod_and_data_splits_pod_major_as_jax_does():
    """Rank r of the (2, 16, 16) mesh holds JAX's slice of device r for
    a dim split over ("pod", "data"): DTensor splits over the first mesh
    dim first, JAX takes the first name as major."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    amesh = jax.sharding.Mesh(
        np.arange(512).reshape(2, 16, 16), ("pod", "data", "model"))
    spec = (("pod", "data"), "model")
    gshape = (64, 32)
    want = NamedSharding(amesh, P(*spec)).devices_indices_map(gshape)
    for rank in (0, 37, 300, 511):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=512)
        mesh = init_device_mesh("cpu", (2, 16, 16),
                                mesh_dim_names=("pod", "data", "model"))
        local, off = compute_local_shape_and_global_offset(
            gshape, mesh, partition.placements(spec, mesh))
        sl = want[amesh.devices.flat[rank]]
        assert tuple(local) == (sl[0].stop - sl[0].start,
                                sl[1].stop - sl[1].start)
        assert tuple(off) == (sl[0].start, sl[1].start)
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="mesh order"):
        partition.placements((("data", "pod"),), fake_mesh(
            (2, 16, 16), ("pod", "data", "model")))


# ------------------------------------------------------------ constraints
CONSTRAINT_CASES = [
    ((4, 8, 16), "residual"), ((4, 8, 16), "ffn_hidden"),
    ((4, 8, 16), "heads"), ((4, 8, 3, 16), "heads"), ((32, 64), "residual"),
    ((8,), "residual"), ((3, 5, 7), "residual"), ((3, 5, 7), "ffn_hidden"),
    ((2, 1, 16), "residual"), ((32, 1, 32), "residual"),
    ((256, 4096, 1536), "residual"), ((8, 4096, 8960), "ffn_hidden"),
    ((1, 32, 48), "heads"), ((16, 24, 25), "heads"),
]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_constraint_rules_match_the_reference(mesh_name, monkeypatch):
    """The reference's ``constrain`` reaches ``with_sharding_constraint``
    with the spec of each rule; that call is replaced here to read it (the
    reference raises on Explicit mesh axes, ROADMAP §3)."""
    shape, names = MESHES[mesh_name]
    amesh = AbstractMesh(shape, names)
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(s.spec) or x)
    for shp, kind in CONSTRAINT_CASES:
        seen.clear()
        with jactivation_mesh(amesh):
            jconstrain(jax.ShapeDtypeStruct(shp, np.float32), kind)
        spec = constraints.constraint_spec(shp, kind,
                                           dict(zip(names, shape)))
        if not seen:
            assert spec is None, (shp, kind)
        else:
            assert _spec(seen[0], len(shp)) == _spec(spec, len(shp)), \
                (shp, kind)


def test_constrain_is_identity_without_a_mesh_or_a_dtensor():
    x = torch.ones(4, 8, 16)
    assert constraints.constrain(x, "residual") is x
    mesh = fake_mesh((2, 2), ("data", "model"))
    with constraints.activation_mesh(mesh):
        assert constraints.constrain(x, "residual") is x
        with pytest.raises(ValueError):
            constraints.constraint_spec((4, 8, 16), "bogus", mesh)


def test_constrain_redistributes_a_dtensor_to_the_rule():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = fake_mesh((2, 2), ("data", "model"))
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(4, 8, 16), mesh,
                               [Replicate(), Replicate()], run_check=False)
        with constraints.activation_mesh(mesh):
            r = constraints.constrain(x, "residual")
            f = constraints.constrain(x, "ffn_hidden")
            odd = constraints.constrain(
                DTensor.from_local(torch.empty(3, 5, 7), mesh,
                                   [Replicate(), Replicate()],
                                   run_check=False), "residual")
            one = constraints.constrain(
                DTensor.from_local(torch.empty(4, 1, 16), mesh,
                                   [Replicate(), Replicate()],
                                   run_check=False), "residual")
    assert r.placements == (Shard(0), Shard(1))
    assert f.placements == (Shard(0), Shard(2))
    assert odd.placements == (Replicate(), Replicate())
    assert one.placements == (Shard(0), Replicate())
    assert r.to_local().shape == (2, 4, 16)


# ------------------------------------------------------------------ mesh
def test_production_mesh_is_a_fake_group_and_refuses_a_real_one():
    mesh = make_production_mesh()
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (16, 16) and dist.get_backend() == "fake"
    multi = make_production_mesh(multi_pod=True)     # replaces the group
    assert multi.mesh_dim_names == ("pod", "data", "model")
    assert dist.get_world_size() == 512
    dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    with pytest.raises(RuntimeError, match="gloo process group of 1"):
        make_production_mesh()


def test_host_mesh_spans_the_process_group():
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device="cpu")
    assert tuple(mesh.shape) == (1, 1) and dist.get_backend() == "gloo"
    with pytest.raises(ValueError, match="do not split"):
        make_host_mesh(model_axis=2, device="cpu")


def test_rules_read_axis_sizes_by_name_from_either_mesh():
    mesh = fake_mesh((2, 4), ("data", "model"))
    assert partition.axis_sizes(mesh) == {"data": 2, "model": 4}
    assert partition.mesh_size(mesh, "pod") == 1
    assert partition.batch_spec(mesh, 6) == (("data",), None)
    assert partition.batch_spec(mesh, 3) == (None, None)
    assert partition.batch_spec({"data": 2, "model": 4}, 6) == \
        partition.batch_spec(mesh, 6)
    assert math.prod(partition.shard_shape((8, 12), ("data", "model"),
                                           mesh)) == 12
