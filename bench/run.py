"""Run one benchmark cell once and print its result as the last line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace 0|1

From the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration file and a traffic mix; this builds the program's serving
engine (``repro_torch``) with weights drawn from the seed on the card,
warms it up on the mix (``bench.traffic``, ``bench.driver``), measures for
``--seconds``, checks the served tokens against the plain reference
(``bench.check``, with the ``Reference`` of the architecture file the
configuration names), and prints one JSON object: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics (the
layers timed from outside, ``bench.layers``; a few rounds after the window
traced with ``torch.profiler``, ``bench.devtrace``).  The set-up time runs
from the process's start to the instant the window opens.

It exits with 2 and prints no result without a CUDA card (or with fewer
than the cell asks for), and with 3 if ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``repro`` (top-level names compared whole) is loaded once the
window has closed.
"""

import time

_T_MODULE = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

#: top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: the traced run profiles the rounds after the window until at least
#: this many rounds and one prefill are in the trace (the profiler's first
#: round is its warm-up and is discarded), or ``TRACE_MAX_ROUNDS``
TRACE_ROUNDS = 8
TRACE_MAX_ROUNDS = 400


def process_start() -> float:
    """The process's start on the ``time.monotonic`` clock (Linux counts
    both from boot), or this module's import time where that cannot be
    read."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
        ticks = int(fields.split()[19])
        start = ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _T_MODULE
    return start if _T_MODULE - 120.0 < start <= _T_MODULE else _T_MODULE


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_text() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def execute(config: dict, traffic: dict, *, seed: int, seconds: float,
            trace: bool, readers: dict, device: str,
            t_start: float, log=print, control: bool = False) -> dict:
    """One run of a cell; returns the result line's object (``metrics``,
    ``correct``, ...), with the compared numbers under ``check``."""
    import torch

    from bench import check, deploy, devtrace, driver, layers, tails
    from bench import manifest
    from bench import traffic as mix
    from bench import weights

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    arch_path = manifest.ROOT / config["reference"]
    arch = manifest.architecture(arch_path)
    engine, system, params, model = deploy.build(config, seed, device)
    abstract = model.abstract_params()
    gib = (lambda: f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
           if cuda else "n/a")
    log(f"built: weights {weights.nbytes(params)} B, peak {gib()}")
    recorder = None
    if trace:
        recorder = (layers.Recorder(sync,
                                    span=torch.profiler.record_function)
                    if cuda else layers.Recorder(sync))
        recorder.install(engine)
    planned = mix.plan(traffic, seed, int(config["model"]["vocab_size"]))
    at_open = {}
    prof = [None]

    def on_round(phase, t0, t1):
        if recorder is not None:
            recorder.end_round(phase, t1 - t0)
        if phase == "after" and prof[0] is not None:
            prof[0].step()

    def on_phase(phase):
        if phase == "window":
            at_open["regrowths"] = engine.staged.regrowths
        if phase == "after" and trace and cuda:
            from torch.profiler import ProfilerActivity, profile, schedule
            sync()
            prof[0] = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1,
                                  active=TRACE_MAX_ROUNDS, repeat=1))
            prof[0].start()

    def traced_enough(n):
        if not trace:
            return True
        traced = [r for r in recorder.rounds if r["phase"] == "after"][1:]
        return n > TRACE_MAX_ROUNDS or (
            len(traced) >= TRACE_ROUNDS
            and any(r["prefills"] for r in traced))

    run = driver.serve(engine, traffic, planned, seconds,
                       done_after=traced_enough, on_round=on_round,
                       on_phase=on_phase)
    sync()
    if prof[0] is not None:
        prof[0].stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    setup_s = run.start - t_start
    stamped = list(run.stamped.values())
    summ = tails.summary(stamped, run.start, run.end)
    summ["rounds"] = len(run.round_walls)
    summ["finished"] = len(run.finished)
    # a pool-buffer regrowth drops every decode graph: none may fall in
    # the window (the warm-up reaches the largest buffer the mix needs)
    summ["regrowths_in_window"] = (engine.staged.regrowths
                                   - at_open["regrowths"])
    log("window: " + ", ".join(f"{k} {v!r}" for k, v in summ.items()))
    log(f"engine: peak {gib()}, staged step {engine.staged.stats()}, "
        f"staged prefill {engine.staged_prefill.stats()}, "
        f"kv {engine.kv.stats()}, link bytes {system.fm.op_bytes()}")
    due_in = [s for s in stamped if run.start <= s.due < run.end]
    attempted = len(due_in)
    failed = sum(1 for s in due_in if s.failed)
    sample = check.draw_sample(
        check.finished_requests(run, engine),
        int(config["check"]["served_tokens_at_least"]), seed)

    out = {"device": {"platform": "gpu" if cuda else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if cuda
                               else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    metrics = {}
    if trace:
        record = {"model": config["model"], "engine": config["engine"],
                  "reference": str(arch_path),
                  "window_s": run.end - run.start,
                  "tokens": summ["tokens"],
                  "rounds": recorder.rounds,
                  "trace": None}
        if prof[0] is not None:
            ops = devtrace.device_ops(prof[0])
            spans = devtrace.host_spans(prof[0])
            win = devtrace.step_window(prof[0])
            if ops and win is not None:
                busy = devtrace.busy_seconds(ops)
                kern = devtrace.kernel_seconds(ops)
                record["trace"] = {
                    "busy_s": busy, "window_s": (win[1] - win[0]) * 1e-6,
                    "kernels": kern,
                    "rounds": [r for r in recorder.rounds
                               if r["phase"] == "after"][1:]}
                out["device"]["busy_s"] = busy
                out["device"]["window_s"] = record["trace"]["window_s"]
                out["breakdown"] = {
                    "device_ops": devtrace.top(kern),
                    "idle_gaps": devtrace.top(
                        devtrace.idle_by_host(ops, spans, win))}
            else:
                log("trace: the profiler recorded no device operation")
        for name, read in readers.items():
            value = read(record)
            if value is not None:
                metrics[name] = float(value)
    prof[0] = None

    # the program's state goes before the reference runs: the reference
    # draws the weights again from the seed and reads nothing the program
    # made but the served tokens it judges
    del engine, params, run
    system.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.monotonic()
    ref_params = weights.make(abstract, seed, device,
                              float(config["init_std"]))
    judged = check.judge(arch.Reference, config["model"], ref_params,
                         sample, control=control)
    del ref_params
    log(f"reference: {time.monotonic() - t_ref:.1f} s")
    ok, compared = check.verdict(judged, config["check"])
    log(f"check: {len(sample)} requests, {judged['tokens']} served tokens, "
        f"widest gap per request {judged['per_request']}")
    if control:
        # the control in the program's place: its tokens judged by the
        # same comparison and limits as the program's
        out["control_correct"], out["control"] = check.verdict(
            dict(judged["control"], tokens=judged["tokens"]),
            config["check"])
    out.update({"setup_s": setup_s, "correct": ok, "attempted": attempted,
                "failed": failed, "metrics": metrics, "summary": summ,
                "check": compared})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()

    from bench import manifest
    man = manifest.load()
    cell = manifest.cell(man, args.workload)
    config = manifest.config(man, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    e2e = manifest.end_to_end(man, cell["name"])
    layer_metrics = manifest.per_layer(man, cell["name"])
    readers = manifest.readers(layer_metrics) if args.trace else {}

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"{cell['name']} needs {cell['chips']} CUDA card(s), found "
              f"{count}", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    res = execute(config, traffic, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), readers=readers,
                  device="cuda", t_start=t_start, log=log)
    bad = forbidden_loaded()
    if bad:
        log(f"loaded in this process, and must not be: {bad}")
        return 3
    log(f"card: {card_text()}")
    metrics = {}
    if args.trace:
        units = {m["name"]: m["unit"] for m in layer_metrics}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in res["metrics"].items()}
    else:
        summ = res["summary"]
        for m in e2e:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": res["setup_s"], "unit": "s"}
            elif m["name"] in summ:
                metrics[m["name"]] = {"value": summ[m["name"]],
                                      "unit": m["unit"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics,
            "device": res["device"]}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["check"] = res["check"]
    for k, v in res["check"].items():
        log(f"check {k}: {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
