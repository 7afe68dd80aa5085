"""Package rules of the port: its copies stay copies, it imports neither
jax nor ``repro``, and its entry points refuse to run on a missing card."""

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
    "models/flags.py", "configs/rwkv6_7b.py", "configs/dbrx_132b.py",
    "configs/mixtral_8x22b.py", "configs/hymba_1_5b.py",
    "configs/granite_34b.py", "configs/h2o_danube_3_4b.py",
    "configs/command_r_plus_104b.py", "configs/chameleon_34b.py",
    "configs/seamless_m4t_large_v2.py", "configs/base.py",
    "train/fault.py", "data/pipeline.py", "data/__init__.py",
]


def _rewritten(rel):
    return re.sub(r"(?<![\w.])repro\.", "repro_torch.",
                  (SRC / "repro" / rel).read_text())


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_equals_the_original(rel):
    assert (PORT / rel).read_text() == _rewritten(rel)


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


def test_static_scan_finds_no_jax_or_repro_import():
    """Top-level and function-level imports alike."""
    pat = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)",
                     re.MULTILINE)
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 30
    assert [p.name for p in files if pat.search(p.read_text())] == []
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
