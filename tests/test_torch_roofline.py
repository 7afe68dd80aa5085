"""The port's roofline and abstract shapes against the reference's.

``roofline_terms`` is fed the reference's HLO snippet on the reference
side and the same collectives as (kind, bytes) records on the port's,
with the reference's TPU v5e figures (``roofline.chips.TPU_V5E``)."""

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.configs.base import list_configs
from repro.models import build_model as jbuild_model
from repro.roofline import analysis as janalysis
from repro.train.loop import abstract_train_state as jabstract_train_state
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.roofline import H100_SXM, TPU_V5E, analysis
from repro_torch.train.loop import abstract_train_state

#: tests/test_sharding_roofline.py's snippet, as the port's records
HLO = """
  %all-reduce.1 = f32[16,4096]{1,0} all-reduce(%x), replica_groups={}
  %all-gather.2 = bf16[8,1024,128]{2,1,0} all-gather(%y), dimensions={1}
  %rs = f32[4,256]{1,0} reduce-scatter(%z), dimensions={0}
  %a2a = (f32[2,2]{1,0}, f32[2,2]{1,0}) all-to-all(%p, %q)
  %notacoll = f32[2,2]{1,0} add(%a, %b)
"""
RECORDS = [("all-reduce", 16 * 4096 * 4), ("all-gather", 8 * 1024 * 128 * 2),
           ("reduce-scatter", 4 * 256 * 4), ("all-to-all", 2 * 2 * 2 * 4)]


def test_records_are_the_snippets_collectives():
    assert sorted(janalysis.parse_collectives(HLO)) == sorted(RECORDS)
    assert analysis.collective_bytes_per_device(RECORDS) == \
        janalysis.collective_bytes_per_device(HLO)
    assert analysis._TRAFFIC_FACTOR == janalysis._TRAFFIC_FACTOR


@pytest.mark.parametrize("cost,chips,mf", [
    ({"flops": 197e12, "bytes accessed": 819e9}, 256, 197e12),
    ({"flops": 3.1e12, "bytes accessed": 2.5e9}, 512, 1e15),
    ({"flops": 0.0, "bytes accessed": 0.0}, 1, 0.0),
    ({"flops": 1e9}, 16, 5e11)])
def test_roofline_terms_match_the_reference_field_for_field(cost, chips, mf):
    j = janalysis.roofline_terms(cost, HLO, chips, mf)
    p = analysis.roofline_terms(cost, RECORDS, chips, mf, TPU_V5E)
    jr, pr = j.row(), p.row()
    assert pr.pop("chip") == TPU_V5E.name
    assert pr == jr
    assert p.step_time_s == j.step_time_s


def test_h100_terms_use_the_datasheet_figures():
    t = analysis.roofline_terms({"flops": 989.4e12, "bytes accessed":
                                 3.35e12}, [("all-reduce", 225e9)], 8,
                                989.4e12 * 8)
    assert t.chip is H100_SXM
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 1.0, 1.0)
    assert t.roofline_fraction == 1.0
    assert "datasheet" in H100_SXM.name
    assert (H100_SXM.peak_flops, H100_SXM.hbm_Bps, H100_SXM.hbm_bytes,
            H100_SXM.link_Bps) == (989.4e12, 3.35e12, 80e9, 450e9)
    assert H100_SXM.fsdp_threshold_bytes == H100_SXM.hbm_bytes / 2


@pytest.mark.parametrize("arch", list_configs())
def test_model_flops_match_for_every_shape(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    for name in JSHAPES:
        for kind in (None, "train", "prefill", "decode"):
            assert analysis.model_flops(cfg, SHAPES[name], kind) == \
                janalysis.model_flops(jcfg, JSHAPES[name], kind)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], (*path, k))]
    return [("/".join(path), tree)]


def _jleaves(tree):
    return [(jax.tree_util.keystr(p, simple=True, separator="/"), l)
            for p, l in jax.tree_util.tree_leaves_with_path(tree)]


def _same(jtree, tree):
    jl, pl = _jleaves(jtree), _leaves(tree)
    assert [p for p, _ in jl] == [p for p, _ in pl]
    for (path, j), (_, p) in zip(jl, pl):
        assert p.device.type == "meta", path
        assert tuple(j.shape) == tuple(p.shape), path
        assert np.dtype(j.dtype).name == \
            str(p.dtype).removeprefix("torch."), path


@pytest.mark.parametrize("arch", list_configs())
def test_abstract_shapes_match_leaf_for_leaf(arch):
    """``abstract_params``, ``abstract_train_state`` (with and without the
    error-feedback residual), ``input_specs`` and ``cache_specs`` of every
    full config, as ``meta`` tensors with the reference's shapes and
    dtypes."""
    jmodel = jbuild_model(jget_config(arch))
    model = build_model(get_config(arch), device="cpu")
    _same(jmodel.abstract_params(), model.abstract_params())
    for ef in (False, True):
        jp, jo = jabstract_train_state(jmodel, ef)
        p, o = abstract_train_state(model, ef)
        _same(jp, p)
        _same(jo, o)
    for name in JSHAPES:
        _same(jmodel.input_specs(name), model.input_specs(SHAPES[name]))
    for name in jmodel.cfg.shape_cells():
        _same(jmodel.cache_specs(name), model.cache_specs(name))


def test_a_cuda_model_gives_its_abstract_params_without_a_card(monkeypatch):
    """The init runs on a CPU generator under FakeTensorMode whatever the
    model's device; nothing is allocated."""
    model = build_model(get_config("qwen2-1.5b"), device="cpu")
    model.device = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = model.abstract_params()
    assert p["embed"]["table"].device.type == "meta"
    assert tuple(p["embed"]["table"].shape) == (152064, 1536)


def test_fsdp_choice_follows_the_chip():
    """The H100's 40 GB threshold leaves FSDP off in the cells whose state
    lies between the reference's 8 GB and it; the list is PERF.md's."""
    changed = []
    for arch in list_configs():
        cfg = get_config(arch)
        for name in cfg.shape_cells():
            shape = SHAPES[name]
            if dryrun._want_fsdp(cfg, shape) != \
                    dryrun._want_fsdp(cfg, shape, TPU_V5E):
                changed.append(f"{arch}|{name}")
    assert changed == [
        "chameleon-34b|train_4k", "command-r-plus-104b|prefill_32k",
        "command-r-plus-104b|decode_32k", "dbrx-132b|prefill_32k",
        "dbrx-132b|decode_32k", "granite-34b|train_4k",
        "mixtral-8x22b|prefill_32k", "mixtral-8x22b|decode_32k",
        "mixtral-8x22b|long_500k"], changed


def test_reference_fsdp_formula_is_the_ported_one():
    """``_want_fsdp`` with ``TPU_V5E`` is the reference's function."""
    import ast
    import pathlib
    src = (pathlib.Path(janalysis.__file__).parents[1] / "launch" /
           "dryrun.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "_want_fsdp")
    ns = {}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "ref", "exec"), ns)
    for arch in list_configs():
        cfg = get_config(arch)
        for name in SHAPES:
            assert ns["_want_fsdp"](cfg, SHAPES[name]) == \
                dryrun._want_fsdp(cfg, SHAPES[name], TPU_V5E)
