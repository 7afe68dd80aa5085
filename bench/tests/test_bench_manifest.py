"""BENCHMARK.json against the benchmark's contract, and every name in it
found by the harness: each cell's configuration, architecture and traffic
file, each per-layer metric's reader.  Adding a configuration (of a new
architecture too), a mix or a metric is new files and new entries."""

import dataclasses
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
        # every model key not declared cut is the registered config's
        assert set(cfg["reduced"]) <= set(cfg["model"])
        for k, v in cfg["model"].items():
            if k not in cfg["reduced"]:
                assert getattr(published, k) == v, k
        cut = {k: cfg["model"][k] for k in cfg["reduced"]}
        assert deploy.arch_config(cfg) == dataclasses.replace(published,
                                                              **cut)


def test_metric_workloads_report_what_they_move():
    for m in MAN["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in
                                  manifest.end_to_end(MAN, cell)}


def _copy(tmp_path):
    """``bench/`` copied to ``tmp_path/repo``, and its files' bytes."""
    root = tmp_path / "repo"
    shutil.copytree(manifest.BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    return root, before


def test_adding_a_cell_is_new_files_and_entries_only(tmp_path):
    """A later change adds a configuration, a mix and a metric: it writes
    new files and appends entries, and the harness finds them with no
    existing file edited."""
    root, before = _copy(tmp_path)
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


#: a second architecture's file, as a later change writes it: the
#: contract's five names, each marking that it was called
PROBE = '''
import torch

CALLS = []


class Reference:
    def __init__(self, model, params, quant=None):
        CALLS.append(("Reference", quant))
        self.vocab = -(-model["vocab_size"] // 256) * 256

    def logits(self, seqs, positions):
        return [torch.zeros(len(p), self.vocab, device=s.device)
                for s, p in zip(seqs, positions)]


def prefill_flops(model, S):
    CALLS.append("prefill_flops")
    return 1e9 * S


def decode_flops(model, context):
    CALLS.append("decode_flops")
    return 1e6 * (context + 1)


def paged_least_s(model, lengths, max_pages):
    CALLS.append("paged_least_s")
    return 1e-7 * sum(lengths)


def flash_least_s(model, S):
    CALLS.append("flash_least_s")
    return 1e-9 * S * S
'''


def test_adding_a_second_architecture_is_new_files_and_entries_only(
        tmp_path, monkeypatch):
    """A configuration of another of the program's models (MoE, at the
    tests' size), with a model key the dense configuration lacks and an
    architecture file of its own, joins as new files and appended
    entries; a run of its cell takes the file's ``Reference`` and the
    count readers its counts, and no file of the copy changes."""
    from bench import counts, deploy
    from bench import run as bench_run
    from bench.tests import small
    from repro_torch.configs.base import get_config
    root, before = _copy(tmp_path)
    cfg = small.config("granite-34b", port="dbrx-132b")
    cfg["name"] = "dbrx-probe"
    cfg["model"].update(num_experts=4, top_k=2)
    cfg["reference"] = "bench/reference/moe_probe.py"
    published = get_config("dbrx-132b")
    cfg["reduced"] = sorted(k for k, v in cfg["model"].items()
                            if getattr(published, k) != v)
    (root / "bench/configs/dbrx-probe.json").write_text(json.dumps(cfg))
    (root / "bench/reference/moe_probe.py").write_text(PROBE)
    man = json.loads(json.dumps(MAN))
    cell = "dbrx-probe.completion"
    man["configs"].append({"name": "dbrx-probe", "source": "x",
                           "file": "bench/configs/dbrx-probe.json",
                           "reduced": cfg["reduced"], "why": "x"})
    man["workloads"].append({"name": cell, "config": "dbrx-probe",
                             "traffic": "completion", "chips": 1,
                             "why": "x"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    loaded = manifest.load(root)
    got = manifest.config(loaded, manifest.cell(loaded, cell)["config"],
                          root)
    assert "num_experts" in got["reduced"] and "top_k" in got["reduced"]
    arch = deploy.arch_config(got)
    assert (arch.block_type, arch.num_experts, arch.top_k) == ("moe", 4, 2)
    assert (published.num_experts, published.top_k) == (16, 4)
    probe = manifest.architecture(got["reference"], root)
    layer_metrics = manifest.per_layer(loaded, cell)
    readers = manifest.readers(layer_metrics, root / "bench")
    # the run resolves the configuration's file from the checkout's root
    monkeypatch.setattr(manifest, "ROOT", root)
    res = bench_run.execute(got, small.traffic("completion"), seed=5,
                            seconds=1.5, trace=True, readers=readers,
                            device="cpu", t_start=0.0, log=lambda m: None,
                            control=True)
    assert ("Reference", None) in probe.CALLS
    assert ("Reference", "fp8") in probe.CALLS
    assert res["correct"], res["check"]
    assert {"prefill_flops", "decode_flops"} <= set(probe.CALLS)
    assert res["metrics"]["serve_mfu"] > 0
    # the traced readers, on a record naming the file
    rec = {"model": got["model"], "engine": got["engine"],
           "reference": str(root / got["reference"]), "window_s": 2.0,
           "rounds": [{"phase": "window", "prefills": [10],
                       "contexts": [[3, 4]]}],
           "trace": {"kernels": {"paged_split_kernel_mma": 1e-3,
                                 "flash_attention_bf16_kernel": 1e-3},
                     "rounds": [{"prefills": [10], "contexts": [[3, 4]]}]}}
    read = {m: manifest.reader(m, root / "bench") for m in
            ("serve_mfu", "paged_attention_roofline",
             "flash_attention_roofline")}
    assert read["serve_mfu"](rec) == pytest.approx(
        100.0 * (1e10 + 1e6 * 9) / (2.0 * counts.PEAK_BF16_FLOPS))
    assert read["paged_attention_roofline"](rec) == pytest.approx(0.07)
    assert read["flash_attention_roofline"](rec) == pytest.approx(0.01)
    assert {"paged_least_s", "flash_least_s"} <= set(probe.CALLS)
    for p, b in before.items():
        assert p.read_bytes() == b


def test_no_card_exits_2_and_prints_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
