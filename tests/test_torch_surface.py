"""The rest of the reference's serving and example surface, on the port.

* ``ServeEngine.submit(prompt, max_new_tokens=, tenant=)``: the
  reference's deprecated positional form, which both packages wrap into a
  ``SubmitSpec`` after a ``DeprecationWarning``.
* ``examples/quickstart_torch.py`` (``--device cpu``) prints what
  ``examples/quickstart.py`` prints, line for line: the same handles, the
  same L2P buffer statistics (hits, modelled link wait) and the same
  fabric snapshot.
* ``examples/ssd_sim_torch.py`` prints the reference simulator's Figure 6
  table at a small I/O count.

Each example runs in this process through ``runpy``, its standard output
captured; the process-wide metric registries of both packages are reset
first, since the L2P buffer's hit ratio reads them.
"""

import contextlib
import io
import re
import runpy
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.core.metrics
import repro.core.offload
import repro.sim as jsim
import repro.sim.ssd as jssd
import repro.sim.workload as jworkload
import repro_torch.core.metrics
from repro.configs.base import get_config as jget_config
from repro.core import system_for as jsystem_for
from repro.models import build_model as jbuild_model
from repro.models.flags import Flags as JFlags
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SubmitSpec as JSubmitSpec
from repro_torch.configs.base import get_config
from repro_torch.core import system_for
from repro_torch.interop import params_from_numpy
from repro_torch.models import build_model
from repro_torch.models.flags import Flags
from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
ECFG = dict(decode_slots=2, max_seq_len=64, page_tokens=8, onboard_pages=4,
            round_time_s=1e-3)


@pytest.fixture(autouse=True)
def _reset_metrics():
    repro.core.metrics.GLOBAL_METRICS.reset()
    repro_torch.core.metrics.GLOBAL_METRICS.reset()
    yield


def _run(path: Path, *args: str) -> str:
    """Standard output of the script at ``path`` run as ``__main__``."""
    out, argv = io.StringIO(), sys.argv
    sys.argv = [str(path), *args]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = argv
    return out.getvalue()


def test_positional_submit_warns_and_serves_as_the_reference(monkeypatch):
    """Both engines take ``submit(prompt, max_new_tokens, tenant=)``, each
    warning once a call, and give the same request ids and greedy
    streams; a ``SubmitSpec`` goes through without a warning."""
    monkeypatch.setattr(repro.core.offload, "backend_memory_kinds",
                        lambda: ("device",))
    arch = "qwen2-1.5b"
    jparams = jbuild_model(jget_config(arch).reduced(),
                           JFlags(remat=False)).init(jax.random.key(0))
    model = build_model(get_config(arch).reduced(), Flags(remat=False),
                        device="cpu")
    engines = (
        JServeEngine(jbuild_model(jget_config(arch).reduced(),
                                  JFlags(remat=False)), jparams,
                     jsystem_for("dev0", host_id="h0", pool_gib=1,
                                 page_bytes=4096),
                     JEngineConfig(**ECFG), device_id="dev0"),
        ServeEngine(model, params_from_numpy(jax.tree_util.tree_map(
            np.asarray, jparams), device="cpu"),
                    system_for("dev0", host_id="h0", pool_gib=1,
                               page_bytes=4096),
                    EngineConfig(**ECFG), device_id="dev0", device="cpu"))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 100, n).astype(np.int32) for n in (9, 14, 6)]
    served = []
    for eng, spec in zip(engines, (JSubmitSpec, SubmitSpec)):
        with pytest.warns(DeprecationWarning, match="SubmitSpec") as got:
            rids = [eng.submit(p, 3 + i, tenant=f"t{i % 2}")
                    for i, p in enumerate(prompts)]
        assert sum(w.category is DeprecationWarning for w in got) == 3
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            rids.append(eng.submit(spec(prompt=prompts[0],
                                        max_new_tokens=2)))
        eng.run(200)
        served.append((rids, [eng.requests[r].out_tokens for r in rids],
                       [eng.requests[r].tenant for r in rids]))
    assert served[0] == served[1]
    assert served[1][0] == [0, 1, 2, 3]
    assert [len(s) for s in served[1][1]] == [3, 4, 5, 2]
    assert served[1][2] == ["t0", "t1", "t0", "default"]
    assert isinstance(engines[1].requests[0].prompt, np.ndarray)
    assert SubmitSpec(prompt=prompts[0]).max_new_tokens == 16


def test_quickstart_twin_prints_what_the_reference_prints():
    """Every line equal, the L2P statistics (64 pages, 8 onboard, clock
    policy, prefetch depth 2, 2,000 zipf(1.5) lookups) and the fabric
    snapshot included: no line needs to differ."""
    ref = _run(EXAMPLES / "quickstart.py")
    repro_torch.core.metrics.GLOBAL_METRICS.reset()
    port = _run(EXAMPLES / "quickstart_torch.py", "--device", "cpu")
    assert port.splitlines() == ref.splitlines()
    assert any(line.startswith("l2p stats: {'pages': 64")
               for line in port.splitlines())


def _table_rows(gen: int, n_ios: int):
    """The reference simulator's Figure 6 rows for one SSD generation,
    formatted as both examples print them."""
    spec = jsim.make_ssd_model(gen)
    schemes = jssd.make_schemes(spec)
    rows = [f"{'workload':<10}" + "".join(f"{s:>16}" for s in schemes)]
    for wl_name in jworkload.ALL_PAPER_WORKLOADS:
        wl = jsim.make_workload(wl_name, n_ios=n_ios)
        ideal = jsim.simulate(spec, schemes["ideal"], wl).iops
        cells = []
        for scheme in schemes.values():
            r = jsim.simulate(spec, scheme, wl)
            cells.append(f"{r.iops/1e3:7.0f}K {r.iops/ideal*100:4.0f}%")
        rows.append(f"{wl_name:<10}" + "".join(f"{c:>16}" for c in cells))
    return rows


def test_ssd_sim_twin_prints_the_reference_table():
    """At 5,000 I/Os a workload: the Gen4 and Gen5 rows are
    ``repro.sim.simulate``'s, under the same headings."""
    lines = _run(EXAMPLES / "ssd_sim_torch.py", "--n-ios", "5000"
                 ).splitlines()
    for gen, fig in ((4, "6a"), (5, "6b")):
        at = lines.index(f"=== PCIe Gen{gen} SSD (Fig {fig}) ===")
        rows = _table_rows(gen, 5000)
        assert lines[at + 1:at + 1 + len(rows)] == rows
    assert lines[-1] == "all LMB schemes >10x DFTL."


@pytest.mark.parametrize("name", ["chip_smoke.py",
                                  "examples/quickstart_torch.py",
                                  "examples/ssd_sim_torch.py",
                                  "examples/serve_paged_torch.py"])
def test_the_card_scripts_import_neither_jax_nor_repro(name):
    """What runs on the card's machine, which has no JAX: the same static
    scan as ``test_torch_port.py``'s, top-level and function-level
    imports alike."""
    pat = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)",
                     re.MULTILINE)
    text = (EXAMPLES.parent / name).read_text()
    assert "repro_torch" in text
    assert not pat.search(text)
