"""Cells cut to a size the CPU runs in seconds, for the harness's tests:
the configuration files' models at their ``.reduced()`` widths in float32,
2 layers, a 4-slot engine over 8 onboard pages of 8 tokens, and each mix's
lengths cut to fit."""

from __future__ import annotations

import copy
import json

from bench import manifest

ENGINE = {"decode_slots": 4, "page_tokens": 8, "max_seq_len": 256,
          "onboard_pages": 8}


def config(name: str, limit: float = 1e-3, port: str = None) -> dict:
    """Configuration ``name`` at this size; ``port`` puts another of the
    program's registered models (reduced) in its place."""
    from repro_torch.configs.base import get_config
    man = manifest.load()
    cfg = copy.deepcopy(manifest.config(man, name))
    if port is not None:
        cfg["port_config"] = port
    r = get_config(cfg["port_config"]).reduced()
    for k in cfg["model"]:
        cfg["model"][k] = getattr(r, k)
    cfg["model"]["num_layers"] = 2
    cfg["engine"] = dict(ENGINE)
    cfg["lmb"]["pool_gib"] = 1
    # the full widths' 0.02 is about 1/sqrt(2,500); at width 64 the same
    # share of the residual stream takes 1/sqrt(64)
    cfg["init_std"] = 0.125
    cfg["check"] = {"at_most": {"widest_gap": limit, "mean_gap": limit},
                    "served_tokens_at_least": 20}
    return cfg


def traffic(name: str) -> dict:
    t = json.loads(json.dumps(manifest.traffic(name)))
    t["prompt"].update(lo=8, hi=48)
    t["output"].update(lo=2, hi=10)
    t["clients"] = 4
    return t


def run(cell: str, seed: int = 3, seconds: float = 2.0, trace: bool = False,
        cfg: dict = None, mix: dict = None, **kw) -> dict:
    """``bench.run.execute`` of a cell at this size on the CPU (its mix,
    or ``mix``)."""
    import time

    from bench import run as bench_run
    man = manifest.load()
    c = manifest.cell(man, cell)
    readers = (manifest.readers(manifest.per_layer(man, cell)) if trace
               else {})
    return bench_run.execute(
        cfg or config(c["config"]), mix or traffic(c["traffic"]), seed=seed,
        seconds=seconds, trace=trace, readers=readers, device="cpu",
        t_start=time.monotonic(), log=lambda m: None, **kw)
