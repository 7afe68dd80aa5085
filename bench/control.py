"""Read the output check's two readings for a cell, on the card.

    python3 bench/control.py --workload <cell> --seconds <s> --seed <n>

One run of the cell (as ``bench/run.py`` makes it, for a short window)
judged twice against the float32 reference: by the tokens
the program served (the lower readings of the widest and the mean gap)
and by the tokens the float8 control (the ``Reference`` of the
configuration's architecture file with ``quant="fp8"``) puts first at the
same positions (the upper readings).
The control goes through the same verdict, with the cell's limits, as
the program (``control_correct``); it exits with 1 if the control came out
correct, or the program did not.  Run it once a seed, each in its own
process as the benchmark's runs are: a second engine in one process does
not find the card empty.  The benchmark's own runs do not run this;
``PERF.md`` records its readings and the limits set between them.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from bench import manifest, run
    man = manifest.load()
    cell = manifest.cell(man, args.workload)
    config = manifest.config(man, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    res = run.execute(config, traffic, seed=args.seed, seconds=args.seconds,
                      trace=False, readers={}, device="cuda",
                      t_start=time.monotonic(), control=True,
                      log=lambda m: print(m, file=sys.stderr, flush=True))
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "correct": res["correct"], "program": res["check"],
                      "control_correct": res["control_correct"],
                      "control": res["control"],
                      "summary": res["summary"]}), flush=True)
    return 0 if res["correct"] and not res["control_correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
