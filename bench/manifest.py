"""Find a cell's files by the names ``BENCHMARK.json`` gives.

A cell names a configuration (``configs[].file``) and a traffic mix
(``bench/traffic/<traffic>.json``); a per-layer metric is read by
``bench/metrics/<name>.py``, which defines ``read(record)``.  Adding a
configuration, a mix or a metric is a new file and a new manifest entry.

A configuration file holds, under these keys:

* ``name``: the entry's name in ``BENCHMARK.json``; ``port_config``: the
  program's registered ``ArchConfig`` it starts from; ``source`` (and
  ``paper``): the published model;
* ``model``: fields of the program's ``ArchConfig`` and nothing else, each
  put into the registered config as it stands (``bench.deploy``); a key
  that is no field fails;
* ``reference``: the path, from the checkout's root, of the architecture
  file (``bench/reference/__init__.py`` says what it exports): the plain
  reference that decides ``correct`` and the yardstick's operation and
  byte counts for this architecture.  Required: a file without it fails,
  naming the file;
* ``flags``, ``init_std``, ``engine``, ``lmb``: the program's ``Flags``, the
  weights' scale (``bench.weights``), the ``EngineConfig`` and the LMB
  stack;
* ``check``: the output check's limits (``bench.check``);
* ``reduced``: the ``model`` keys that depart from the registered config
  (the chip's share of a deployment, fewer layers), the same list as the
  configuration's entry; every other ``model`` key equals the registered
  config's;
* ``assumed``: departures from the published model and sizes set without
  a source; ``memory``: how the card's memory is filled.

A new architecture is therefore a configuration file, an architecture
file and appended entries; no file the harness has is edited.
"""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Union

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in manifest['workloads']]}")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            cfg = json.loads((root / c["file"]).read_text())
            if "reference" not in cfg:
                raise KeyError(f"{c['file']} names no architecture file: "
                               f"give its path under \"reference\"")
            return cfg
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, bench: Path = BENCH) -> dict:
    return json.loads((bench / "traffic" / f"{name}.json").read_text())


def end_to_end(manifest: dict, cell_name: str) -> List[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in manifest["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer(manifest: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics the cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end(manifest, cell_name)}
    return [m for m in manifest["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _architecture(path: Path) -> ModuleType:
    return _module(path, "bench_arch_" + path.stem)


def architecture(path: Union[str, Path], root: Path = ROOT) -> ModuleType:
    """The architecture file at ``path`` (a configuration's
    ``reference``, from ``root``), loaded once: its ``Reference`` and its
    counts."""
    return _architecture((root / path).resolve())


def reader(name: str, bench: Path = BENCH) -> Callable[[dict], object]:
    """``read`` of ``bench/metrics/<name>.py``."""
    return _module(bench / "metrics" / f"{name}.py",
                   "bench_metric_" + name).read


def readers(metrics: List[dict], bench: Path = BENCH
            ) -> Dict[str, Callable[[dict], object]]:
    return {m["name"]: reader(m["name"], bench) for m in metrics}
