"""The port's dry run against the reference's.

Argument bytes of every (config, shape, production mesh) cell from the
port's specs equal the reference's shard arithmetic.  The traced
qwen2-1.5b × decode_32k × single cell gives the reference's argument
bytes (952,277,028 per device), model FLOPs and, but for what XLA keeps
that the port does not, its output bytes; its collectives, kind by kind,
equal those XLA's SPMD partitioner issues, and the compiled HLO's exceed
them by the CPU backend's widening of bf16 collectives, exactly.  Its
other figures are printed beside the reference's (``pytest -s``), and
the reference's temporary
bytes are shown to grow with depth where the port's peak does not.  The
reference side runs
in a subprocess: ``repro.launch.dryrun`` forces 512 host devices when it
is imported, and its mesh needs Auto axes patched in at run time
(ROADMAP §3), which this script does without touching ``src/repro``.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, get_config, list_configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.zoo import Model
from repro_torch.roofline import TPU_V5E

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
#: what XLA's output of a decode step holds and the port's does not: the
#: output tuple's index table, 8 B a leaf (logits, step, k, v, pos).  The
#: step counter is a device int32 in both
XLA_ONLY_OUTPUT = 8 * 5
#: what XLA's CPU backend adds to the decode step's collectives after SPMD
#: partitioning, per device and weighted: its ``all-reduce-promotion`` and
#: ``float-normalization-bf16`` passes run each bf16 collective in f32, at
#: twice the bytes.  The partitioner's bf16 collectives are the ones the
#: port issues; every other kind is equal
CPU_WIDENING = {"step": {"all-reduce": 2_801_664, "all-gather": 2_433_024},
                "body_per_layer": {"all-reduce": 98_304}}
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}

REFERENCE = r'''
import dataclasses, glob, json, math, sys, tempfile
import jax
from repro.launch import dryrun as d
from jax.sharding import AbstractMesh, AxisType, NamedSharding
from repro.configs.base import SHAPES, get_config, list_configs
from repro.models.flags import Flags
from repro.models.zoo import build_model
from repro.roofline.analysis import _TRAFFIC_FACTOR, parse_collectives
from repro.sharding.partition import (batch_spec, cache_shardings,
                                      param_shardings)
from repro.train.loop import abstract_train_state


def auto_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes,
                         axis_types=(AxisType.Auto,) * len(shape))


d.make_production_mesh = auto_mesh
rec = d.run_cell("qwen2-1.5b", "decode_32k", "single", verbose=False)
out = {"run_cell": {k: rec.get(k) for k in ("status", "memory",
                                            "body_per_layer", "roofline")},
       "depth": {}, "bytes": {}, "collectives": {}}


def by_kind(hlo):
    got = dict.fromkeys(_TRAFFIC_FACTOR, 0.0)
    for kind, n in parse_collectives(hlo):
        got[kind] += n * _TRAFFIC_FACTOR[kind]
    return got


# run_cell's three compiles again, each collective kind apart: in the
# compiled HLO (what run_cell counts) and in the HLO right after SPMD
# partitioning, before the CPU backend's own passes
qwen = get_config("qwen2-1.5b")
for name, L, flags in (("full", qwen.num_layers, Flags()),
                       ("scan2", 2, Flags()),
                       ("unroll2", 2, Flags(unroll_layers=True))):
    fn, args = d.build_cell(dataclasses.replace(qwen, num_layers=L),
                            SHAPES["decode_32k"], auto_mesh(), flags)
    with tempfile.TemporaryDirectory() as tmp:
        with d.activation_mesh(auto_mesh() if flags.act_constraints
                               else None):
            lowered = fn.lower(*args)
        compiled = lowered.compile(compiler_options={
            "xla_dump_to": tmp,
            "xla_dump_hlo_pass_re": "spmd-partitioning"})
        [part] = glob.glob(f"{tmp}/*after_spmd-partitioning*")
        with open(part) as f:
            out["collectives"][name] = {
                "compiled": by_kind(compiled.as_text()),
                "partitioned": by_kind(f.read())}
# the compiled step's memory at depth 1 and 2 (the layers in one scan)
for L in (1, 2):
    out["depth"][L] = d._measure(
        dataclasses.replace(get_config("qwen2-1.5b"), num_layers=L),
        SHAPES["decode_32k"], auto_mesh(), Flags())["memory"]


def nbytes(tree, shard):
    return sum(math.prod(s.shard_shape(tuple(l.shape))) * l.dtype.itemsize
               for l, s in zip(jax.tree_util.tree_leaves(tree),
                               jax.tree_util.tree_leaves(shard)))


# build_cell's shardings, from the reference's own rules
for arch in list_configs():
    cfg = get_config(arch)
    model = build_model(cfg, Flags())
    params = model.abstract_params()
    opt = abstract_train_state(model)[1]
    for name in cfg.shape_cells():
        shape = SHAPES[name]
        B, S = shape.global_batch, shape.seq_len
        fsdp = d._want_fsdp(cfg, shape)
        for kind, msh, axes in (("single", (16, 16), ("data", "model")),
                                ("multi", (2, 16, 16),
                                 ("pod", "data", "model"))):
            mesh = AbstractMesh(msh, axes)
            trees = [(params, param_shardings(params, mesh, cfg,
                                              fsdp=fsdp))]
            if shape.kind == "train":
                trees.append((opt, d.opt_state_shardings(opt, mesh, cfg,
                                                         fsdp=fsdp)))
            if shape.kind != "decode":
                specs = model.input_specs(shape)
                trees.append((specs, {k: NamedSharding(mesh, batch_spec(
                    mesh, B, len(v.shape) - 1)) for k, v in specs.items()}))
            if shape.kind != "train":
                cache = jax.eval_shape(lambda: model.init_cache(B, S))
                trees.append((cache, cache_shardings(cache, mesh, cfg, B)))
            if shape.kind == "decode":
                tok = jax.ShapeDtypeStruct((B, 1), jax.numpy.int32)
                trees.append((tok, NamedSharding(mesh, batch_spec(mesh, B,
                                                                  1))))
            out["bytes"][f"{arch}|{name}|{kind}"] = sum(
                nbytes(t, s) for t, s in trees)
print(json.dumps(out))
'''


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE], cwd=SRC,
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cli_table(tmp_path_factory):
    """The port's CLI on qwen2-1.5b × decode_32k × single, run once."""
    path = tmp_path_factory.mktemp("dryrun") / "table.json"
    argv = ["--arch", "qwen2-1.5b", "--shape", "decode_32k", "--mesh",
            "single", "--out", str(path)]
    dryrun.main(argv)
    try:
        return path, argv, dryrun.load_table(str(path))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _port_record(cli_table):
    return cli_table[2][dryrun.cell_key("qwen2-1.5b", "decode_32k",
                                        "single")]


def test_traced_cell_gives_the_reference_bytes_and_flops(reference,
                                                         cli_table):
    ref = reference["run_cell"]
    assert ref["status"] == "ok"
    assert ref["memory"]["argument_size_in_bytes"] == 952_277_028
    rec = _port_record(cli_table)
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["memory"]["argument_size_in_bytes"] == 952_277_028
    assert rec["roofline"]["model_flops"] == ref["roofline"]["model_flops"]
    assert ref["memory"]["output_size_in_bytes"] - \
        rec["memory"]["output_size_in_bytes"] == XLA_ONLY_OUTPUT
    print("\nqwen2-1.5b x decode_32k x single, per device unless global:")
    for key in ("argument_size_in_bytes", "output_size_in_bytes"):
        print(f"  {key}: reference {ref['memory'][key]:,}, "
              f"port {rec['memory'][key]:,}")
    print(f"  reference temp_size_in_bytes "
          f"{ref['memory']['temp_size_in_bytes']:,}, port peak "
          f"{rec['memory']['peak_size_in_bytes']:,}")
    for key in ("hlo_flops", "hlo_bytes", "coll_bytes_per_dev"):
        print(f"  {key}: reference {ref['roofline'][key]:.6g}, port "
              f"{rec['roofline'][key]:.6g}")
    for key in ("flops", "bytes", "coll"):
        print(f"  body_per_layer {key}: reference "
              f"{ref['body_per_layer'][key]:.6g}, port "
              f"{rec['body_per_layer'][key]:.6g}")
    print(f"  dominant: reference {ref['roofline']['dominant']} "
          f"(TPU v5e), port {rec['roofline']['dominant']} "
          f"({rec['roofline']['chip']})")
    assert set(rec) >= {"status", "memory", "raw_artifact",
                        "body_per_layer", "roofline"}
    assert rec["roofline"]["dominant"] == "memory"
    assert rec["roofline"]["chips"] == 256


def _reference_kinds(reference, hlo: str) -> dict:
    """The reference's weighted bytes per kind, whole step (full-depth
    scan plus L - 1 bodies, as its ``run_cell`` counts) and per layer
    (unrolled minus scanned at depth 2)."""
    got = {name: rec[hlo] for name, rec in reference["collectives"].items()}
    body = {k: got["unroll2"][k] - got["scan2"][k] for k in KINDS}
    layers = get_config("qwen2-1.5b").num_layers
    return {"step": {k: got["full"][k] + (layers - 1) * body[k]
                     for k in KINDS},
            "body_per_layer": body}


def test_collectives_kind_by_kind_are_the_partitioners(reference,
                                                       cli_table):
    """Each kind of collective in the port's decode step, whole and per
    layer, equals what XLA's SPMD partitioner issues; the compiled HLO
    holds more by ``CPU_WIDENING`` exactly.  The port reduces a partial
    sum where its product makes it (``dryrun._summed``), as the
    partitioner does; before that rule its step moved 1.87× the compiled
    bytes."""
    rec = _port_record(cli_table)
    port = {scope: {k: rec["coll_by_kind"][scope].get(k, 0.0)
                    for k in KINDS}
            for scope in ("step", "body_per_layer")}
    compiled = _reference_kinds(reference, "compiled")
    part = _reference_kinds(reference, "partitioned")
    print("\ncollectives, weighted bytes per device: reference compiled, "
          "reference after SPMD partitioning, port")
    for scope in port:
        for k in KINDS:
            print(f"  {scope} {k}: {compiled[scope][k]:,.0f}, "
                  f"{part[scope][k]:,.0f}, {port[scope][k]:,.0f}")
    ref = reference["run_cell"]
    assert sum(compiled["step"].values()) == \
        ref["roofline"]["coll_bytes_per_dev"]
    assert sum(compiled["body_per_layer"].values()) == \
        ref["body_per_layer"]["coll"]
    assert port == part
    assert sum(port["step"].values()) == rec["roofline"]["coll_bytes_per_dev"]
    for scope in port:
        assert {k: compiled[scope][k] - part[scope][k] for k in KINDS} == \
            {k: CPU_WIDENING[scope].get(k, 0) for k in KINDS}
    assert rec["rewrites"]["partial_sum"] == \
        1 + 2 * get_config("qwen2-1.5b").num_layers


def test_reference_temp_grows_with_depth_where_the_port_peak_does_not(
        reference, cli_table):
    """XLA's temporaries for the scanned decode grow by more than a layer's
    cache shard with each layer; the port frees each layer's temporaries
    before the next, so its peak stays put.  Outputs differ by the same
    ``XLA_ONLY_OUTPUT`` at every depth."""
    cfg, shape = get_config("qwen2-1.5b"), SHAPES["decode_32k"]
    mesh = make_production_mesh()
    port = {L: dryrun.measure_cell(dataclasses.replace(cfg, num_layers=L),
                                   shape, mesh)["memory"] for L in (1, 2)}
    port[cfg.num_layers] = _port_record(cli_table)["memory"]
    ref = {int(L): m for L, m in reference["depth"].items()}
    ref[cfg.num_layers] = reference["run_cell"]["memory"]
    # one layer's K and V shards: 8 sequences x 2,048 slots x 2 heads x 128
    layer_cache = 2 * 8 * 2048 * 2 * 128 * 2
    print("\nlayers: reference temp_size_in_bytes, port peak (per device)")
    for L in sorted(ref):
        print(f"  {L}: {ref[L]['temp_size_in_bytes']:,}, "
              f"{port[L]['peak_size_in_bytes']:,}")
        assert ref[L]["output_size_in_bytes"] - \
            port[L]["output_size_in_bytes"] == XLA_ONLY_OUTPUT
    assert ref[2]["temp_size_in_bytes"] - ref[1]["temp_size_in_bytes"] > \
        layer_cache
    assert ref[28]["temp_size_in_bytes"] - ref[2]["temp_size_in_bytes"] > \
        26 * layer_cache
    assert port[28]["peak_size_in_bytes"] - port[1]["peak_size_in_bytes"] \
        < layer_cache / 100


def test_a_second_cli_run_reports_the_cell_cached(cli_table, capsys):
    path, argv, table = cli_table
    capsys.readouterr()
    dryrun.main(argv)
    out = capsys.readouterr().out
    assert "[qwen2-1.5b|decode_32k|single|base] cached" in out
    assert "1 ok / 0 fail / 0 skipped" in out
    assert dryrun.load_table(str(path)) == table


def test_argument_bytes_match_the_reference_in_every_cell(reference,
                                                          monkeypatch):
    """The port's ``build_cell`` specs under the reference's FSDP
    threshold (``TPU_V5E``), every shape of every config on both
    production meshes."""
    cache = {}
    orig = Model.abstract_params

    def once(self):
        if self.cfg.name not in cache:
            cache[self.cfg.name] = orig(self)
        return cache[self.cfg.name]

    monkeypatch.setattr(Model, "abstract_params", once)
    got = {}
    for arch in list_configs():
        cfg = get_config(arch)
        for name in cfg.shape_cells():
            for kind, mesh in MESHES.items():
                _, args, specs = dryrun.build_cell(cfg, SHAPES[name], mesh,
                                                   chip=TPU_V5E)
                got[f"{arch}|{name}|{kind}"] = dryrun.argument_bytes(
                    args, specs, mesh)
    assert got == reference["bytes"]
    assert len(got) == 2 * sum(len(get_config(a).shape_cells())
                               for a in list_configs())
