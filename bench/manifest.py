"""Find a cell's files by the names ``BENCHMARK.json`` gives.

A cell names a configuration (``configs[].file``) and a traffic mix
(``bench/traffic/<traffic>.json``); a per-layer metric is read by
``bench/metrics/<name>.py``, which defines ``read(record)``.  Adding a
configuration, a mix or a metric is a new file and a new manifest entry.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

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
            return json.loads((root / c["file"]).read_text())
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


def reader(name: str, bench: Path = BENCH) -> Callable[[dict], object]:
    """``read`` of ``bench/metrics/<name>.py``."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def readers(metrics: List[dict], bench: Path = BENCH
            ) -> Dict[str, Callable[[dict], object]]:
    return {m["name"]: reader(m["name"], bench) for m in metrics}
