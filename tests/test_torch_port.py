"""Package rules of the port: its copies stay copies, it imports neither
jax nor ``repro``, and its entry points refuse to run on a missing card."""

import ast
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    """tests/conftest.py resets only the reference's GLOBAL_METRICS."""
    from repro_torch.core.metrics import GLOBAL_METRICS
    GLOBAL_METRICS.reset()
    yield

#: modules copied from repro, equal to the original once ``repro.`` reads
#: ``repro_torch.``
COPIES = [
    "configs/qwen2_1_5b.py", "obs/__init__.py", "obs/trace.py",
    "obs/hist.py", "obs/export.py", "core/tiers.py", "core/pool.py",
    "core/placement.py", "core/metrics.py", "core/policy.py",
    "core/overlap.py", "core/faults.py", "core/fabric.py", "core/api.py",
    "core/client.py", "qos/arbiter.py", "qos/slo.py", "rack/topology.py",
    "configs/rwkv6_7b.py", "configs/dbrx_132b.py",
    "configs/mixtral_8x22b.py", "configs/hymba_1_5b.py",
    "configs/granite_34b.py", "configs/h2o_danube_3_4b.py",
    "configs/command_r_plus_104b.py", "configs/chameleon_34b.py",
    "configs/seamless_m4t_large_v2.py", "configs/base.py",
    "train/fault.py", "data/pipeline.py", "data/__init__.py",
    "sim/workload.py", "qos/contention.py", "qos/migration.py",
    "qos/__init__.py", "sim/ssd.py", "rack/des.py", "sim/engine.py",
    "sim/__init__.py", "rack/scenarios.py",
]

#: copies whose module docstring was edited (it named the change that
#: landed the code); everything below the docstring is the original's
DOCSTRING_EDITED = ["serve/loadgen.py", "rack/__init__.py"]

#: copies whose comments say what the port does where the original's
#: speak of the TPU; their code and docstrings are the original's
COMMENT_EDITED = ["models/flags.py"]


#: copies the port extends: they put the serving path's spans on the
#: profiler's clock (``obs/trace.py``), mark the spans whose duration is
#: modeled (``core/fabric.py``, ``core/faults.py``) and give those a track
#: of their own (``obs/export.py``); each holds every line of the
#: original, in order, and only adds lines
EXTENDED = ["obs/trace.py", "obs/export.py", "core/fabric.py",
            "core/faults.py"]


def _rewritten(rel):
    return re.sub(r"(?<![\w.])repro\.", "repro_torch.",
                  (SRC / "repro" / rel).read_text())


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_equals_the_original(rel):
    """Equal to the original, or, for a copy the port extends
    (``EXTENDED``), the original with lines added and none changed."""
    port, orig = (PORT / rel).read_text(), _rewritten(rel)
    if rel not in EXTENDED:
        assert port == orig
        return
    import difflib
    ops = difflib.SequenceMatcher(None, orig.splitlines(), port.splitlines(),
                                  autojunk=False).get_opcodes()
    assert {op for op, *_ in ops} == {"equal", "insert"}


def _without_docstring(text):
    tree = ast.parse(text)
    assert isinstance(tree.body[0].value, ast.Constant)
    return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[])), \
        text.split('"""', 2)[2]


@pytest.mark.parametrize("rel", DOCSTRING_EDITED)
def test_copied_module_differs_only_in_its_docstring(rel):
    port, orig = (PORT / rel).read_text(), _rewritten(rel)
    assert port != orig
    assert _without_docstring(port) == _without_docstring(orig)


@pytest.mark.parametrize("rel", COMMENT_EDITED)
def test_copied_module_differs_only_in_comments(rel):
    port, orig = (PORT / rel).read_text(), _rewritten(rel)
    assert port != orig
    assert ast.dump(ast.parse(port)) == ast.dump(ast.parse(orig))


def test_serve_exports_the_reference_names_and_decode_view():
    import repro.serve
    import repro_torch.serve
    assert set(repro_torch.serve.__all__) == \
        set(repro.serve.__all__) | {"DecodeView"}


def test_config_base_differs_only_in_load_all():
    """configs/base.py is now a plain copy (``COPIES``); its ``_load_all``
    registers the same ten configs as the reference's."""
    from repro.configs.base import list_configs as jlist_configs
    from repro_torch.configs.base import list_configs
    # every config of the reference, the encoder-decoder one included
    assert list_configs() == jlist_configs() == (
        "chameleon-34b", "command-r-plus-104b", "dbrx-132b", "granite-34b",
        "h2o-danube-3-4b", "hymba-1.5b", "mixtral-8x22b", "qwen2-1.5b",
        "rwkv6-7b", "seamless-m4t-large-v2")


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith(('jax.', 'jaxlib')) or n == 'repro' or "
        "n.startswith('repro.'))\n"
        "n = sum(1 for k in sys.modules if k.startswith('repro_torch'))\n"
        "print(n, bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(" ", 1)
    assert int(count) > 30
    assert bad.strip() == "[]"


def test_sharding_dry_run_and_roofline_load_no_jax_and_no_group():
    """The dry run's modules, imported alone: no jax, no ``repro``, no
    process group and no XLA flags (the reference's dry run sets them
    when imported)."""
    code = (
        "import os, sys\n"
        "import repro_torch.sharding, repro_torch.sharding.constraints\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.mesh\n"
        "import repro_torch.roofline, repro_torch.roofline.chips\n"
        "import torch.distributed as dist\n"
        "assert 'jax' not in sys.modules\n"
        "assert not any(n == 'repro' or n.startswith(('repro.', 'jax'))\n"
        "               for n in sys.modules)\n"
        "assert not dist.is_initialized()\n"
        "assert 'XLA_FLAGS' not in os.environ\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=120,
                         env=dict(env, PYTHONPATH=str(SRC)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_new_modules_the_example_and_chip_smoke_load_no_jax():
    """The reference's last names in the port (``scan_utils``,
    ``batch_sharding``, the layer helpers, ``move_page``), the training
    example and ``chip_smoke.py``, each loaded as a module in a fresh
    interpreter: ``"jax" not in sys.modules``, and nothing of
    ``repro``."""
    root = SRC.parent
    code = (
        "import importlib.util, sys\n"
        "from repro_torch.models.scan_utils import scan_layers\n"
        "from repro_torch.models.layers import (causal_mask, layer_norm,\n"
        "                                       layer_norm_init)\n"
        "from repro_torch.models.transformer import layer_init\n"
        "from repro_torch.sharding import batch_sharding\n"
        "from repro_torch.core.offload import TierExecutor\n"
        "assert TierExecutor.move_page\n"
        "for name in ('examples/train_offload_torch.py', 'chip_smoke.py'):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name.split('/')[-1][:-3], name)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert 'jax' not in sys.modules\n"
        "assert not any(n == 'repro' or n.startswith(('repro.', 'jax'))\n"
        "               for n in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_static_scan_finds_no_jax_or_repro_import():
    """Top-level and function-level imports alike."""
    pat = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)",
                     re.MULTILINE)
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 30
    assert [p.name for p in files if pat.search(p.read_text())] == []
    # the examples' twins and chip_smoke.py, which run without jax too
    root = SRC.parent
    others = sorted(root.glob("examples/*_torch.py")) + \
        [root / "chip_smoke.py"]
    assert len(others) >= 5
    assert [p.name for p in others if pat.search(p.read_text())] == []
    assert pat.search("    from repro.core import api\n")
    assert pat.search("import jax.numpy as jnp\n")
    assert not pat.search("from repro_torch.core import api\n")


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """Nothing drops to the CPU quietly: without CUDA each entry point
    raises unless it is given device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.configs.base import get_config
    from repro_torch.core import TierExecutor, system_for
    from repro_torch.interop import params_from_numpy, tensor_from_numpy
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import Model, build_model
    from repro_torch.serve import EngineConfig, ServeEngine
    cfg = get_config("qwen2-1.5b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TierExecutor()
    tree = {"embed": {"table": np.zeros((4, 2), np.float32)}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy(tree)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tensor_from_numpy(tree["embed"]["table"])
    assert params_from_numpy(tree, device="cpu")["embed"]["table"].device \
        == torch.device("cpu")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(model, params, system_for("dev0"), EngineConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--requests", "1"])
    eng = ServeEngine(model, params, system_for("dev0"), EngineConfig(),
                      device="cpu")
    assert eng.device.type == "cpu"


def test_launcher_serves_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--device", "cpu", "--requests", "2",
                       "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert '"done": 2' in out and '"device": "cpu"' in out
