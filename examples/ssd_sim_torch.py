"""Reproduce the paper's Figure 6 (LMB vs Ideal vs DFTL on Gen4/Gen5 SSDs)
with the PyTorch port's simulator.

The port's twin of ``examples/ssd_sim.py``: the same table from
``repro_torch.sim``, a host-only discrete-event model (no device runs).
``--n-ios`` sets each workload's I/O count (the reference's 100,000 by
default; smaller runs quicker).

Run:  PYTHONPATH=src python examples/ssd_sim_torch.py [--n-ios N]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.sim import make_ssd_model, make_workload, simulate
from repro_torch.sim.ssd import make_schemes
from repro_torch.sim.workload import ALL_PAPER_WORKLOADS

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("--n-ios", type=int, default=100_000,
                    help="I/Os per workload (default 100,000)")
n_ios = parser.parse_args().n_ios

for gen in (4, 5):
    spec = make_ssd_model(gen)
    schemes = make_schemes(spec)
    print(f"\n=== PCIe Gen{gen} SSD (Fig 6{'a' if gen == 4 else 'b'}) ===")
    print(f"{'workload':<10}" + "".join(f"{s:>16}" for s in schemes))
    for wl_name in ALL_PAPER_WORKLOADS:
        wl = make_workload(wl_name, n_ios=n_ios)
        ideal = simulate(spec, schemes["ideal"], wl).iops
        cells = []
        for sname, scheme in schemes.items():
            r = simulate(spec, scheme, wl)
            cells.append(f"{r.iops/1e3:7.0f}K {r.iops/ideal*100:4.0f}%")
        print(f"{wl_name:<10}" + "".join(f"{c:>16}" for c in cells))

print("""
Paper anchors: Gen4 writes LMB==Ideal, DFTL ~7-8x worse; Gen4 reads
LMB-PCIe -13..17%; Gen5 randread LMB-CXL -56%, LMB-PCIe -70%;
all LMB schemes >10x DFTL.""")
