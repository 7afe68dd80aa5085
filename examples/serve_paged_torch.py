"""Serving with LMB-backed KV capacity on the PyTorch port: more in-flight
KV than "HBM".

The port's twin of ``examples/serve_paged.py``.  Submits a burst of
requests whose combined KV exceeds the onboard page budget; cold
sequences spill to the LMB pool, requests still finish, and two requests
share a common, page-aligned prompt prefix zero-copy (fork).
h2o-danube-3-4b has a sliding window, so it decodes on the dense slot
path: each request alone in its slot, the step staged as one CUDA graph
per slot (its first step eager, its second captured, the rest replayed).
Prefill is staged too, one CUDA graph per prompt length, each writing
into the engine's one static prefill cache (a length's first prefill
eager, its second captured, the rest replayed).  On the CPU the same
static buffers are used and the functions called directly.

Run:  PYTHONPATH=src python examples/serve_paged_torch.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import DeviceSpec, HostSpec, LMBSystem, SystemSpec
from repro_torch.models import build_model
from repro_torch.models.flags import Flags
from repro_torch.models.layers import dtype_of
from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
device = parser.parse_args().device

cfg = get_config("h2o-danube-3-4b").reduced()
model = build_model(cfg, Flags(remat=False, use_kernels=True), device=device)
params = model.init(torch.Generator(device=device).manual_seed(0))

system = LMBSystem(SystemSpec(
    expanders=1, pool_gib=4,
    hosts=(HostSpec("server", page_bytes=4096),),
    devices=(DeviceSpec("gpu0"),)))

eng = ServeEngine(model, params, system, EngineConfig(
    decode_slots=3, max_seq_len=96, page_tokens=8,
    onboard_pages=6,          # deliberately tiny HBM-tier budget
    prefill_bucket=16), device_id="gpu0", device=device)

rng = np.random.default_rng(0)
rids = [eng.submit(SubmitSpec(
            prompt=rng.integers(0, cfg.vocab_size, int(n)),
            max_new_tokens=8))
        for n in rng.integers(8, 40, 8)]
eng.run()

st = eng.stats()
print("all done:", all(eng.requests[r].state == "done" for r in rids))
print("decode path:", st["decode_path"], "staged:", eng.staged.stats())
print("staged prefill:", eng.staged_prefill.stats())
print("kv stats:", st["kv"])
c = eng.kv.buf.metrics.tier(eng.kv.buf.name, "onboard")
print(f"onboard hit ratio {c.hit_ratio:.2f}  "
      f"(misses={c.misses} -> paged via LMB pool)")

# zero-copy prefix fork (Table-2 share applied to KV pages): 16 tokens,
# two whole pages of 8
sid = eng.kv.new_seq()
L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
eng.kv.append_tokens(sid, torch.ones((L, 2, 16, KV, hd), dtype=dtype_of(cfg),
                                     device=eng.device))
fork = eng.kv.fork(sid)
print(f"forked seq {sid} -> {fork} with zero new LMB bytes "
      f"(owned={system.host().owned_bytes('gpu0')})")
system.close()
