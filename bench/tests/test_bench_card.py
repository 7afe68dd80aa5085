"""The benchmark's command on a card: one short run of the first cell,
whose last line is the contract's result object.  Skips without a card."""

import json
import subprocess
import sys

import pytest

from bench import manifest


@pytest.mark.cuda
def test_first_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = manifest.load()["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=1200,
        cwd=str(manifest.ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(line)
    assert line["correct"] and line["device"]["platform"] == "gpu"
