"""BENCHMARK.json against the benchmark's contract, and every name in it
found by the harness: each cell's configuration and traffic file, each
per-layer metric's reader.  Adding a configuration, a mix or a metric is
a new file and a new entry."""

import json
import re
import shutil

import pytest

from bench import manifest, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = manifest.load()
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert 1 <= MAN["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s: 2 + 14 runs a cell of
    # run_seconds + 60 s each, 180 s a cell to compile, 1,200 s spare
    cells = 24
    assert (2 + 14 * cells) * (MAN["run_seconds"] + 60) + cells * 180 \
        + 1200 <= 43200
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_exactly_their_keys_and_legal_names():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    assert len(CELLS) == len(set(CELLS))
    assert {m["name"]: m["bound"] for m in MAN["end_to_end"]}["setup_s"] \
        == 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files_and_reports_enough(cell):
    w = manifest.cell(MAN, cell)
    cfg = manifest.config(MAN, w["config"])
    traffic = manifest.traffic(w["traffic"])
    assert {"model", "engine", "lmb", "flags", "check"} <= set(cfg)
    assert int(traffic["clients"]) >= 1 and traffic["why"]
    e2e = {m["name"] for m in manifest.end_to_end(MAN, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = manifest.per_layer(MAN, cell)
    assert layers
    for m in layers:
        assert m["moves"] in e2e
        assert callable(manifest.reader(m["name"]))


def test_configs_are_the_programs_and_every_one_is_used():
    from bench import deploy
    from repro_torch.configs.base import get_config
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for c in MAN["configs"]:
        cfg = manifest.config(MAN, c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        published = get_config(cfg["port_config"])
        # nothing reduced: every model key is the registered config's
        for k, v in cfg["model"].items():
            assert getattr(published, k) == v, k
        assert deploy.arch_config(cfg) == published


def test_metric_workloads_report_what_they_move():
    for m in MAN["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in
                                  manifest.end_to_end(MAN, cell)}


def test_adding_a_cell_is_new_files_and_entries_only(tmp_path):
    """A later change adds a configuration, a mix and a metric: it writes
    new files and appends entries, and the harness finds them with no
    existing file edited."""
    root = tmp_path / "repo"
    shutil.copytree(manifest.BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    man = json.loads(json.dumps(MAN))
    cfg = manifest.config(MAN, "granite-34b")
    cfg["name"] = "granite-34b-wide"
    (root / "bench/configs/granite-34b-wide.json").write_text(
        json.dumps(cfg))
    mix = manifest.traffic("completion")
    mix["clients"] = 4
    (root / "bench/traffic/tiny.json").write_text(json.dumps(mix))
    (root / "bench/metrics/rounds_in_window.py").write_text(
        "def read(rec):\n    return float(len(rec['rounds']))\n")
    man["configs"].append({"name": "granite-34b-wide", "source": "x",
                           "file": "bench/configs/granite-34b-wide.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "granite-34b-wide.tiny",
                             "config": "granite-34b-wide", "traffic": "tiny",
                             "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "rounds_in_window", "unit": "rounds",
                             "better": "higher", "source": "program_counter",
                             "layer": "engine", "moves": "tokens_per_s"})
    for m in man["end_to_end"]:
        if "workloads" in m and m["name"] == "tokens_per_s":
            m["workloads"].append("granite-34b-wide.tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    loaded = manifest.load(root)
    w = manifest.cell(loaded, "granite-34b-wide.tiny")
    assert manifest.config(loaded, w["config"], root)["name"] == \
        "granite-34b-wide"
    assert manifest.traffic(w["traffic"], root / "bench")["clients"] == 4
    names = [m["name"] for m in manifest.per_layer(loaded, w["name"])]
    assert names == ["rounds_in_window"]
    read = manifest.reader("rounds_in_window", root / "bench")
    assert read({"rounds": [1, 2]}) == 2.0
    for p, b in before.items():
        assert p.read_bytes() == b


def test_no_card_exits_2_and_prints_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
