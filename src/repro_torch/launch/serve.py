"""Serving launcher: continuous batching with LMB-backed KV capacity.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --requests 16 --decode-slots 4 [--device cpu]

Port of ``repro.launch.serve`` (the ``.reduced()`` config, random weights
from a seeded ``torch.Generator``).  Runs on the CUDA device unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import DeviceSpec, HostSpec, LMBSystem, SystemSpec
from repro_torch.devices import resolve_device
from repro_torch.models import build_model
from repro_torch.models.flags import Flags
from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--decode-slots", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--onboard-pages", type=int, default=16)
    ap.add_argument("--pool-gib", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, Flags(remat=False, use_kernels=True),
                        device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))

    spec = SystemSpec(expanders=1, pool_gib=args.pool_gib,
                      hosts=(HostSpec("server", page_bytes=4096),),
                      devices=(DeviceSpec("gpu0"),))
    with LMBSystem(spec) as system:
        eng = ServeEngine(model, params, system, EngineConfig(
            decode_slots=args.decode_slots, max_seq_len=128, page_tokens=16,
            onboard_pages=args.onboard_pages), device=device)
        rng = np.random.default_rng(0)
        t0 = time.monotonic()
        for _ in range(args.requests):
            eng.submit(SubmitSpec(
                prompt=rng.integers(0, cfg.vocab_size,
                                    int(rng.integers(4, 48))),
                max_new_tokens=args.max_new_tokens))
        eng.run()
        wall = time.monotonic() - t0
        st = eng.stats()
        st["device"] = str(device)
        st["wall_s"] = wall
        st["tok_per_s"] = args.requests * args.max_new_tokens / wall
        print(json.dumps(st, indent=1, default=str))


if __name__ == "__main__":
    main()
