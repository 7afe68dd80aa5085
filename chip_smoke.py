#!/usr/bin/env python3
"""Drive the PyTorch port of LMB on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device and build: the card's name and power limit, the host's CPU
     model, cores, RAM and load average, then ``nvcc``
     builds every kernel of the main paths from ``src/repro_torch/kernels/
     csrc`` (one process per source, all started together);
  2. kernels against their plain PyTorch versions on the card, at the
     serving paths' full-width shapes (f32 within 1e-4, bf16 within 2e-2,
     absolute: the paged plain version rounds p to bf16 and the paged
     kernel does not; the flash kernel rounds p to bf16 and its plain
     version does not; each check also prints the largest |plain|, since
     one bf16 step passes 2e-2 from magnitude 4 up), on the paged split
     plan's edges at full width (rows ending inside a split, trailing
     splits with no live token, every page live, a page table of 13
     columns over 7 splits, B = 1 at 512 tokens), at a small shape with
     the edge cases (length 0, lengths on a page boundary, unmapped pages
     holding garbage, a mixed batch, ``scale_override=0.0``), and for
     flash on S not a multiple of its tiles, windows across tile edges,
     B = 2, every head_dim route (16, 32, 64, 96, 128, 144, 256) and a
     non-causal case; the WKV6 scan within rtol = atol = 2e-4 at full
     width (bf16 and f32) and on its edge cases (a single chunk, a ragged
     S, strong decay, w with exact zeros, a batch with a nonzero initial
     state, head size 16, S = 1, 16, 64, 65 and 257 across the kernel's
     sub-chunk and chunk edges, a nonzero state at head size 32, zeros in
     w at S = 257), every output finite; then each kernel timed at the
     main path's shapes two ways: ``ms``, a call as issued from Python
     (what a serve round pays, the wrapper's host time included), and
     ``device_ms``, a CUDA graph of calls replayed (the kernels' device
     time alone); beside
     its plain version's time, its bound and, for flash,
     ``scaled_dot_product_attention`` timed both ways as a yardstick the
     port never calls.  Paged and flash are also checked at dbrx-132b's
     shapes (48 heads over 8 KV heads) and flash at hymba-1.5b's (25 over
     5, head_dim 64, window 1024, S = 256 and 1100) and at
     seamless-m4t-large-v2's decoder prefill (B = 8, S = 32, 16 heads over
     16 KV heads, head_dim 64), which gets its own ``kernels`` row;
  3. serve qwen2-1.5b: full width in bf16 with the kernels on, random
     weights from a seed, KV paged over an LMB tier in pinned host memory
     and spilling to it; launch counts are reset just before and read just
     after this run, and a second run times each engine stage apart;
  4. serve rwkv6-7b: full width in bf16 with the kernels on, the same 8
     prompt lengths, its recurrent state in each request's dense slot (no
     KV, so no LMB traffic, by the reference's design); one scan launch
     per prompt and layer between the reset and the read of the counts;
     a second run times prefill and decode apart;
  4b. serve dbrx-132b (MoE, 16 experts, top-4) at full width, 8 of its 40
     layers, on the LMB-paged path: one paged launch per layer and round,
     one flash launch per layer and prompt; the breakdown times the MoE
     layer apart;
  4c. serve hymba-1.5b (attention and SSM heads in parallel) at full
     width and depth on the dense slot path, its KV in LMB pages: one
     flash launch and one ``ssd_scan`` call per layer and prompt; the
     breakdown times the SSM branch apart;
  4d. seamless-m4t-large-v2 (encoder-decoder) at full width and depth
     through ``Model`` (the engine refuses it, as the reference's cannot
     feed its source embeddings): 8 sources of 512 frame embeddings, a
     32-token target prefix, 32 greedy decode steps; encode, decoder
     prefill and decode timed apart; one flash launch per decoder layer
     and prefill (the encoder is not causal and takes no kernel);
  5. reference: each reduced config in f32 (qwen2-1.5b, rwkv6-7b,
     dbrx-132b, mixtral-8x22b, hymba-1.5b) served on the card and on the
     CPU (plain versions, which the tests hold to the JAX reference) must
     give the same logits, token streams and link bytes; reduced
     seamless-m4t-large-v2 the same prefill logits (within 1e-5) and
     greedy token streams through ``Model``;
  6. training through ``repro_torch.launch.train`` (no kernel: the
     reference trains with ``use_kernels=False``, and the kernels have no
     backward).  6a: full-width qwen2-1.5b in bf16, 6 steps of 8 x 256
     tokens in 2 microbatches, int8 error-feedback compression, its
     24,702,574,596 B of optimizer state parked in pinned host memory
     between steps; each step's page-in, forward and backward,
     compression, AdamW and page-out timed apart, the bytes moved each way
     (which must equal the state's), the tier of every parked leaf (which
     must be pinned host), device memory between steps (which must be
     under the state's size) and at peak, every loss finite.  6b: five
     reduced configs in f32 trained 5 steps on the card and on the CPU
     from the same params must give the same losses (1e-5 relative) and
     params.  6c: a run stopped by the failure injector and resumed from
     its checkpoint gives the uninterrupted run's losses, and the loss
     falls over 30 steps.
  7. the load sweep through ``repro_torch.serve.loadgen`` (after phase 4d
     and phase 5 respectively).  7a: full-width qwen2-1.5b in bf16 with
     the kernels on, two tenants (Poisson and bursty, 16 requests each at
     7.5 requests/s of virtual time, prompts of 16-256 tokens, 16-32 new
     tokens) replayed by ``run_sweep`` on a virtual clock with a pinned
     20 ms round, three times on the same trace: (i) pipelined on one
     expander, (ii) phased, (iii) pipelined on two expanders with a
     ``MigrationEngine`` round after every step.  Each run prints its
     ``SweepReport`` (virtual time, modelled from ``tpu_tiers()``) apart
     from what the card measured (wall time, round wall time synchronised,
     tokens/s, peak memory, link bytes, launches; for (iii) the pages and
     bytes moved and the time inside ``run_once``), and fails unless all
     32 requests finish, paged launches equal 28 x paged rounds and flash
     28 x prefills, the buffer's invariants hold, (ii) and (iii) give (i)'s
     streams, (iii) moves a page and (ii) exposes strictly more link wait.
     7b: ``serve_sweep``'s own trace on reduced qwen2-1.5b in f32, card
     against CPU: equal ``SweepReport``s and streams, and on two expanders
     equal migration reports round by round.
  8. the dry run (``repro_torch.launch.dryrun``; no kernel: it traces the
     reference's XLA path, ``use_kernels=False``).  8a, host only: the
     port's ``run_cell`` for qwen2-1.5b x decode_32k on the production
     meshes, ``single`` (256 fake ranks) and ``multi`` (512), each
     roofline row with the H100's datasheet figures, the argument,
     output and peak bytes per device and the trace time; ``single``'s
     argument bytes must be the reference's 952,277,028.  8b, one card,
     mesh (1, 1), full-width qwen2-1.5b in bf16 from seed 0: a decode step
     at B = 16 against a 4,096-token cache and a train step of 8 x 256
     tokens with AdamW's state on the card, each predicted by the dry run
     (DTensors on a fake one-rank mesh, the code path of the production
     meshes, which on one rank issues no collective) and then run on the
     card through the CUDA model's own ``decode_step`` and
     ``make_train_step`` (after one warm-up step): the predicted
     argument bytes must equal the real tensors' ``nbytes`` and the
     predicted peak must lie within 10 % (decode) and 20 % (train) of the
     rise in ``torch.cuda.max_memory_allocated()`` over the step; each
     prints the measured step time beside the roofline's and their ratio.

Each phase's prompts are drawn from its model's vocabulary, and each
serve phase starts from a card that the previous one's params have left.

The last lines are the ``kernels`` JSON (each kernel's launches on the
training path too, none, and on the load sweep's run (i)), the card's name and power limit,
and ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --against OTHER_CHECKOUT

times the paged, flash and WKV6 scan wrappers of another checkout of the
port (for example the parent commit, unpacked with ``git archive``) and of
this one at the main path's bf16 shapes, both ways, in four fresh
processes (other, this, this, other), and prints one JSON line per turn.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
KERNEL_SOURCES = ("paged_attention", "flash_attention", "rwkv6_scan")
#: the kernels each served path launches: the LMB-paged path (qwen2-1.5b,
#: dbrx-132b; hymba-1.5b prefills through flash too) and rwkv6-7b's
PAGED_KERNELS = ("paged_attention", "flash_attention")
RWKV_KERNELS = ("rwkv6_scan",)
#: qwen2-1.5b's attention (H, KV, hd) and its serve phase's page tokens T
#: and page-table width MP (max_seq_len 512 / 32)
ATTN_SHAPE = (12, 2, 128, 32, 16)
#: dbrx-132b's attention (H, KV, hd), and hymba-1.5b's with its window
DBRX_ATTN = (48, 8, 128)
HYMBA_ATTN = (25, 5, 64, 1024)
#: seamless-m4t-large-v2's decoder prefill in phase 4d: (B, S, H, KV, hd),
#: multi-head (KV = H, so one query head per KV head)
SEAMLESS_FLASH = (8, 32, 16, 16, 64)
#: phase 4d's workload: 8 sources of 512 frames, a 32-token target prefix,
#: 32 greedy decode steps into a self-attention cache of 128 slots
SEAMLESS_RUN = dict(batch=8, src_len=512, prefix=32, steps=32, cache=128)
#: the layers of dbrx-132b's 40 that one 80 GB card holds in bf16 with
#: room to serve (6.52 GB a layer, 1.23 GB of embedding)
DBRX_LAYERS = 8
#: seamless-m4t-large-v2's parameters (the reference's abstract_params)
SEAMLESS_PARAMS = 1_369_826_304
#: qwen2-1.5b's parameters (the reference's abstract_params) and its
#: optimizer state with the error-feedback residual: four float32 copies
#: (m, v, master, ef_err) and the int32 step count, 24,702,574,596 B
QWEN_PARAMS = 1_543_910_912
QWEN_STATE_BYTES = 16 * QWEN_PARAMS + 4
#: phase 6a: full-width qwen2-1.5b through the training launcher
TRAIN_RUN = dict(steps=6, global_batch=8, seq_len=256, grad_accum=2,
                 compress_grads=True, offload_opt=True)
TRAIN_STAGES = ("page_in", "fwd_bwd", "compress", "adamw", "page_out")
#: phase 6b: the reduced configs trained on the card and on the CPU
TRAIN_ARCHS = ("qwen2-1.5b", "rwkv6-7b", "dbrx-132b", "hymba-1.5b",
               "seamless-m4t-large-v2")
#: losses card against CPU (f32), relative; params: every element within
#: PARAM_TOL but for one in a thousand, each of which Adam may move by up
#: to 2 * lr a step where a last-bit difference flips a tiny gradient
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
#: phase 7a: serve_sweep's two tenants (benchmarks/run.py) at phase 3's
#: lengths; 2 x 7.5 rps is 90 % of the 16.7 rps that 8 slots carry at 24
#: new tokens a request and a 20 ms round (a modelled rate)
SWEEP_LOAD = dict(n=16, rate_rps=7.5, prompt_tokens=(16, 256),
                  max_new_tokens=(16, 32))
#: phase 3's KV geometry (917,504 B pages, 16 onboard), the round pinned
SWEEP_ECFG = dict(decode_slots=8, page_tokens=32, max_seq_len=512,
                  onboard_pages=16, round_time_s=0.02)
#: phase 8a: the reference's argument bytes per device for qwen2-1.5b x
#: decode_32k x single, summed from its own specs' shard shapes (params
#: 482,449,408, cache 469,827,588 with its int32 step, token 32)
DRYRUN_ARG_BYTES = 952_277_028
#: phase 8b, one card, mesh (1, 1): (kind, seq_len, batch, bound on the
#: predicted peak against the real rise): a decode step at B = 16 against
#: a 4,096-token cache, a train step of 8 x 256 tokens, AdamW on the card
DRYRUN_CELLS = (("decode", 4096, 16, 0.10), ("train", 256, 8, 0.20))
#: phase 7b: serve_sweep's own trace and engine, on reduced qwen2-1.5b
REDUCED_SWEEP_LOAD = dict(n=12, rate_rps=150.0, prompt_tokens=(12, 28),
                          max_new_tokens=(4, 8))
REDUCED_SWEEP_ECFG = dict(decode_slots=4, max_seq_len=64, page_tokens=8,
                          onboard_pages=6, prefill_bucket=16,
                          round_time_s=2e-3)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def host_line() -> str:
    """The host's CPU model, cores, total RAM and load average: what a
    reader of host-bound times and PCIe rates needs beside them."""
    import os
    import platform
    model, mem = platform.processor() or platform.machine(), 0
    try:
        info = {}
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                info.setdefault(key.strip().lower(), val.strip())
        if info.get("model name", "unknown") != "unknown":
            model = info["model name"]
        elif "vendor_id" in info:       # no brand string: vendor and ids
            model = (f"{info['vendor_id']} family "
                     f"{info.get('cpu family', '?')} model "
                     f"{info.get('model', '?')}")
        with open("/proc/meminfo") as f:
            mem = next(int(l.split()[1]) * 1024 for l in f
                       if l.startswith("MemTotal"))
    except OSError:
        pass
    load = " ".join(f"{x:.2f}" for x in os.getloadavg())
    return (f"host {model}, {os.cpu_count()} cores, {mem / 2**30:.1f} GiB "
            f"RAM, load {load}")


def time_ms(fn, iters: int = 30, repeats: int = 5, warmup: int = 3) -> float:
    """Time per call as issued from Python (the host's issue time where it
    is longer than the device's): the median of ``repeats`` runs of
    ``iters`` calls, since one stall of a shared host skews a whole run."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return sorted(runs)[repeats // 2]


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time per call: ``calls`` calls captured in one CUDA graph,
    replayed ``replays`` times between two events, so the host's dispatch
    time (Python, ctypes) drops out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # relaxed: a launcher may set a kernel attribute while being captured
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, got, want, tol: float) -> float:
    """Hold got to want within ``tol``, absolute; returns the max abs err.
    Prints the largest |want| beside it: bf16 rounds a value of magnitude
    m in steps of up to m / 128, so one step passes 2e-2 from m = 4 up."""
    err = max_err(got, want)
    print(f"  {name}: max_abs_err={err:.3e} (tol {tol:g}), "
          f"max|plain|={float(want.float().abs().max()):.3g}")
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
    return err


def print_ptxas(name: str, log: str) -> None:
    """One line per kernel instantiation (its mangled name, which carries
    the template arguments): registers, shared memory and spills, from
    ``nvcc -Xptxas -v``."""
    entry, spill = "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            print(f"  {name}: {entry}: {line.split(':', 1)[-1].strip()}; "
                  f"{spill}")


# ----------------------------------------------------------------- phase 2
def paged_inputs(torch, gen, dtype, B, H, KV, hd, T, MP, lengths, L=3,
                 layer=1, garbage=True):
    """A serving-pool-shaped input: per-layer strided views of a
    [P, L, 2, T, KV, hd] pool, pages scattered, unmapped pages garbage."""
    dev = "cuda"
    pages = [max(1, -(-int(n) // T)) if n else 0 for n in lengths]
    P = sum(pages) + 2
    pool = torch.randn((P, L, 2, T, KV, hd), generator=gen, device=dev)
    if garbage:
        pool[-2:] = 1e4                    # never mapped: must not leak
    pool = pool.to(dtype)
    perm = torch.randperm(P - 2, generator=gen, device=dev).tolist()
    table = torch.full((B, MP), -1, dtype=torch.int32)
    for b in range(B):
        for i in range(pages[b]):
            table[b, i] = perm.pop()
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(dtype)
    return (q, pool[:, layer, 0], pool[:, layer, 1], table.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def main_path_inputs(torch, serve_lengths, S):
    """The bf16 inputs the timings use, from a fresh seed (the same in
    every process): the paged kernel's decode batch of the serve phase,
    as per-layer views of a 28-layer pool, and flash's longest prompt."""
    H, KV, hd, T, MP = ATTN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(3)
    dt = torch.bfloat16
    paged = paged_inputs(torch, gen, dt, len(serve_lengths), H, KV, hd, T, MP,
                         serve_lengths, L=28, layer=5)
    flash = tuple(torch.randn((1, S, h, hd), generator=gen,
                              device="cuda").to(dt) for h in (H, KV, KV))
    return paged, flash


def both_times(fn) -> dict:
    """``ms``, a call as issued from Python, and ``device_ms``, the
    device time of a call from a replayed CUDA graph."""
    return {"ms": time_ms(fn), "device_ms": graph_ms(fn)}


def kernel_phase(torch, serve_lengths, prompt_max):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    H, KV, hd, T, MP = ATTN_SHAPE
    sms = pa.sm_count(torch.device("cuda", 0))

    def plan(B, mp):
        return pa.split_plan(B, KV, mp, G=H // KV, sm_count=sms)

    errs = {"paged_attention": 0.0, "flash_attention": 0.0,
            "flash_seamless": 0.0}
    print(f"phase 2: kernels against their plain versions ({sms} SMs)")
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[1]
        # paged: the decode batch of the serve phase, full width
        args = paged_inputs(torch, gen, dtype, len(serve_lengths), H, KV, hd,
                            T, MP, serve_lengths, L=28, layer=5)
        e = check(f"paged {tag} full width B={len(serve_lengths)} plan="
                  f"{plan(len(serve_lengths), MP)}",
                  pa.paged_attention_cuda(*args),
                  pa.paged_attention_plain(*args), tol[dtype])
        if dtype == torch.bfloat16:
            errs["paged_attention"] = e
        # paged at dbrx-132b's decode batch (48 heads over 8 KV heads)
        h, kv, d = DBRX_ATTN
        B = len(serve_lengths)
        args = paged_inputs(torch, gen, dtype, B, h, kv, d, T, MP,
                            serve_lengths, L=DBRX_LAYERS, layer=5)
        dplan = pa.split_plan(B, kv, MP, G=h // kv, sm_count=sms)
        check(f"paged {tag} dbrx-132b B={B} H={h} KV={kv} plan={dplan}",
              pa.paged_attention_cuda(*args),
              pa.paged_attention_plain(*args), tol[dtype])
        # paged at full width, the split plan's edges: rows that end inside
        # a split of two pages and trailing splits with no live token (B 16
        # gives 8 splits of 2 pages), every page of MP live, MP = 13 not a
        # multiple of its 7 splits, and B = 1 at max_seq_len 512 (16 pages)
        for B, mp, lengths in ((16, 16, [512, 33, 0, 1] * 3 + [500, 95, 64,
                                                               2]),
                               (16, 13, [13 * T, 37, 0, 70] * 4),
                               (1, 16, [512]), (1, 16, [301])):
            a = paged_inputs(torch, gen, dtype, B, H, KV, hd, T, mp, lengths)
            out = pa.paged_attention_cuda(*a)
            check(f"paged {tag} full width B={B} MP={mp} plan="
                  f"{plan(B, mp)} lengths={lengths}", out,
                  pa.paged_attention_plain(*a), tol[dtype])
            for b, n in enumerate(lengths):
                if n == 0 and bool(out[b].abs().max() != 0):
                    raise AssertionError("length-0 row is not zero")
        # paged edge cases at hd 16 (the reduced config's head_dim)
        edge = [([0, 9], None), ([8, 12], None), ([0, 4], None),
                ([16, 1, 0, 7], None), ([13, 20], 0.0), ([3], None)]
        for lengths, so in edge:
            B = len(lengths)
            a = paged_inputs(torch, gen, dtype, B, 8, 2, 16, 4, 6, lengths)
            out = pa.paged_attention_cuda(*a, scale_override=so)
            check(f"paged {tag} hd16 lengths={lengths} scale={so}", out,
                  pa.paged_attention_plain(*a, scale_override=so),
                  tol[dtype])
            for b, n in enumerate(lengths):
                if n == 0 and bool(out[b].abs().max() != 0):
                    raise AssertionError("length-0 row is not zero")
        # flash: the longest prompt at full width (qwen2-1.5b, dbrx-132b,
        # hymba-1.5b with its window of 1024, and past it), then edge
        # cases: S not a multiple of the 32-row q tile or the 64-key tile,
        # windows that cross tile edges, B = 2, head dims 16/64/128/256 and
        # the padded ones between (32 -> 64, 96 -> 128, 144 -> 256), not
        # causal
        hh, hkv, hd_h, hwin = HYMBA_ATTN
        for (B, S, h, kv, d, window, causal) in (
                (1, prompt_max, H, KV, hd, None, True),
                (*SEAMLESS_FLASH, None, True),
                (1, prompt_max, *DBRX_ATTN, None, True),
                (1, prompt_max, hh, hkv, hd_h, hwin, True),
                (1, 1100, hh, hkv, hd_h, hwin, True),
                (1, 100, H, KV, hd, None, True),
                (2, 70, H, KV, hd, 40, True),
                (1, prompt_max, H, KV, hd, 100, True),
                (2, 100, 4, 1, 16, 24, True),
                (1, 70, 6, 2, 16, None, True),
                (1, 64, 8, 8, 64, 16, True),
                (2, 130, 4, 2, 64, None, True),
                (1, 100, 4, 2, 32, None, True),
                (1, 100, 4, 2, 96, 50, True),
                (1, 90, 4, 1, 144, None, True),
                (1, 100, 4, 1, 256, None, True),
                (1, 100, 4, 2, 64, None, False)):
            q = torch.randn((B, S, h, d), generator=gen, device="cuda")
            k = torch.randn((B, S, kv, d), generator=gen, device="cuda")
            v = torch.randn((B, S, kv, d), generator=gen, device="cuda")
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            e = check(f"flash {tag} B={B} S={S} H={h} KV={kv} hd={d} "
                      f"window={window} causal={causal}",
                      fa.flash_attention_cuda(q, k, v, causal=causal,
                                              window=window),
                      fa.flash_attention_plain(q, k, v, causal=causal,
                                               window=window), tol[dtype])
            if dtype == torch.bfloat16 and S == prompt_max and \
                    window is None and h == H:
                errs["flash_attention"] = e
            if dtype == torch.bfloat16 and (B, S, h, kv, d) == \
                    SEAMLESS_FLASH:
                errs["flash_seamless"] = e
    torch.cuda.synchronize()

    # timing at the main path's shapes, bf16
    esz = 2
    args, (q, k, v) = main_path_inputs(torch, serve_lengths, prompt_max)
    live = sum(serve_lengths)
    B = len(serve_lengths)
    pa_bytes = (2 * live * KV * hd + 2 * B * H * hd) * esz \
        + args[3].numel() * 4 + B * 4
    pa_flops = 4 * live * H * hd
    pa_bound = max(pa_bytes / HBM_BYTES_PER_S,
                   pa_flops / PEAK_FLOPS["bfloat16"]) * 1e3
    pa_times = both_times(lambda: pa.paged_attention_cuda(*args))
    pa_plain_ms = time_ms(lambda: pa.paged_attention_plain(*args))

    gen = torch.Generator(device="cuda").manual_seed(5)
    B_s, S_s, H_s, KV_s, hd_s = SEAMLESS_FLASH
    seamless = tuple(torch.randn((B_s, S_s, h, hd_s), generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     for h in (H_s, KV_s, KV_s))
    return [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:106",
         "launches": 0, "max_abs_err": errs["paged_attention"],
         "ms": pa_times["ms"], "plain_ms": pa_plain_ms, "bound_ms": pa_bound,
         "bound_by": ("bytes" if pa_bytes / HBM_BYTES_PER_S
                      >= pa_flops / PEAK_FLOPS["bfloat16"]
                      else "operations"),
         "library_ms": None, "device_ms": pa_times["device_ms"],
         "shape": f"B={B} H={H} KV={KV} hd={hd} T={T} MP={MP} "
                  f"live_tokens={live} bf16, plan {plan(B, MP)}"},
        flash_row(torch, F, fa, (q, k, v), errs["flash_attention"],
                  "qwen2-1.5b"),
        flash_row(torch, F, fa, seamless, errs["flash_seamless"],
                  "seamless-m4t-large-v2"),
    ]


def flash_row(torch, F, fa, qkv, err, path) -> dict:
    """The flash kernel's ``kernels`` row at one path's prefill shape
    (bf16, causal): both times, the plain version's, the bound, and
    ``scaled_dot_product_attention``'s times and its error against the
    plain version."""
    q, k, v = qkv
    B, S, H, hd = q.shape
    KV = k.shape[2]
    flops = 4 * B * (S * (S + 1) // 2) * hd * H
    nbytes = (2 * B * S * H * hd + 2 * B * S * KV * hd) * q.element_size()
    by_ops = flops / PEAK_FLOPS["bfloat16"]
    by_bytes = nbytes / HBM_BYTES_PER_S
    times = both_times(lambda: fa.flash_attention_cuda(q, k, v))
    qt, kt, vt = (x.transpose(1, 2) for x in qkv)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    lib = both_times(sdpa)
    lib_err = max_err(sdpa().transpose(1, 2),
                      fa.flash_attention_plain(q, k, v))
    print(f"  sdpa vs flash plain bf16 B={B} S={S} H={H} KV={KV}: "
          f"max_abs_err={lib_err:.3e}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:94",
            "launches": 0, "max_abs_err": err, "ms": times["ms"],
            "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v)),
            "bound_ms": max(by_ops, by_bytes) * 1e3,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "library_ms": lib["ms"], "device_ms": times["device_ms"],
            "library_device_ms": lib["device_ms"], "path": path,
            "shape": f"B={B} S={S} H={H} KV={KV} hd={hd} causal bf16"}


def close(name: str, got, want, tol: float) -> float:
    """Hold got to want within rtol = atol = tol; returns the max abs err."""
    import torch
    err = max_err(got, want)
    print(f"  {name}: max_abs_err={err:.3e} (rtol=atol={tol:g})")
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"{name}: not within rtol=atol={tol}")
    return err


def wkv_inputs(torch, gen, B, S, H, N, dtype, decay="weak",
               state_scale=0.0):
    """r, k, v in ``dtype`` and f32 w, u, state, as the model passes them
    (weak decay: w in (0.69, 0.99); strong: w down to about 0.01)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    r, k, v = (randn(B, S, H, N).to(dtype) for _ in range(3))
    if decay == "strong":
        w = torch.exp(-torch.exp(torch.rand((B, S, H, N), generator=gen,
                                            device="cuda") * 3.5 - 2.0))
    else:
        w = torch.sigmoid(randn(B, S, H, N)) * 0.3 + 0.69
    return r, k, v, w, randn(H, N) * 0.2, randn(B, H, N, N) * state_scale


def wkv_cost(B, S, H, N, esz):
    """Bytes the scan must move (r, k, v in ``esz`` bytes, w, u, state,
    out and state' in f32, each once) and the operations it does: per
    token and head, the read-out r S (N^2 multiply-adds), the update
    w S + k^T v (N^2 multiplies and multiply-adds) and the bonus
    (r u k) v (4N), a multiply-add counting as two."""
    nbytes = (3 * esz + 4 + 4) * B * S * H * N + 4 * H * N \
        + 2 * 4 * B * H * N * N
    flops = B * S * H * (5 * N * N + 4 * N)
    return nbytes, flops


def wkv_main_inputs(torch, prompt_max):
    """The bf16 scan inputs the timings use, from a fresh seed (the same in
    every process): one rwkv6-7b prefill of the longest prompt."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    return wkv_inputs(torch, gen, 1, prompt_max, 64, 64, torch.bfloat16)


def rwkv_kernel_phase(torch, prompt_max):
    """The WKV6 scan against its plain version, then timed at the full
    width of one rwkv6-7b prefill of the longest prompt."""
    from repro_torch.kernels import rwkv6_scan as rw

    gen = torch.Generator(device="cuda").manual_seed(2)
    tol = 2e-4
    H, N = 64, 64
    print("phase 2: rwkv6_scan against its plain version")
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[1]
        args = wkv_inputs(torch, gen, 1, prompt_max, H, N, dtype)
        out, st = rw.rwkv6_scan_cuda(*args)
        pout, pst = rw.rwkv6_scan_plain(*args)
        if not (torch.isfinite(out).all() and torch.isfinite(st).all()):
            raise AssertionError(f"wkv {tag} full width: not finite")
        e = close(f"wkv {tag} full width B=1 S={prompt_max} H={H} N={N} "
                  "out", out, pout, tol)
        close(f"wkv {tag} full width state'", st, pst, tol)
        if dtype == torch.bfloat16:
            err = e
        for label, (B, S, h, n, decay, scale, zeros) in {
                "single chunk": (1, 17, 4, 64, "weak", 0.0, False),
                "ragged S": (1, 100, 4, 64, "weak", 0.0, False),
                "strong decay": (1, 256, 4, 64, "strong", 0.0, False),
                "w with zeros": (1, 130, 4, 64, "strong", 0.0, True),
                "B=2, state": (2, 96, 4, 64, "weak", 0.5, False),
                "head size 16": (2, 70, 4, 16, "strong", 0.5, False),
                # the chunked kernel's edges: sub-chunks of 16, chunks of 64
                "S=1": (1, 1, 4, 64, "weak", 0.5, False),
                "S=16": (1, 16, 4, 64, "strong", 0.0, False),
                "S=64": (1, 64, 4, 64, "weak", 0.0, False),
                "S=65": (2, 65, 4, 64, "strong", 0.5, False),
                "S=257": (1, 257, 4, 64, "weak", 0.0, False),
                "head size 32, state": (2, 100, 4, 32, "weak", 0.5, False),
                "w with zeros, S=257": (1, 257, 4, 64, "strong", 0.0, True),
        }.items():
            r, k, v, w, u, st0 = wkv_inputs(torch, gen, B, S, h, n, dtype,
                                            decay, scale)
            if zeros:
                w[:, ::7] = 0.0
                w[:, :, 1, :4] = 0.0
            out, st = rw.rwkv6_scan_cuda(r, k, v, w, u, st0)
            pout, pst = rw.rwkv6_scan_plain(r, k, v, w, u, st0)
            if not (torch.isfinite(out).all() and torch.isfinite(st).all()):
                raise AssertionError(f"wkv {tag} {label}: not finite")
            close(f"wkv {tag} {label} B={B} S={S} H={h} N={n} out", out,
                  pout, tol)
            close(f"wkv {tag} {label} state'", st, pst, tol)
    torch.cuda.synchronize()

    args = wkv_main_inputs(torch, prompt_max)
    groups = rw.scan_plan(1, H, N, rw.cuda_build.sm_count(0))
    smem = rw.shared_bytes(torch.bfloat16, N, groups)
    print(f"  wkv plan at full width: {groups} column groups per head, "
          f"{groups * H} blocks, {smem} B of shared memory each")
    nbytes, flops = wkv_cost(1, prompt_max, H, N, 2)
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = flops / PEAK_FLOPS["float32"]
    times = both_times(lambda: rw.rwkv6_scan_cuda(*args))
    plain_ms = time_ms(lambda: rw.rwkv6_scan_plain(*args), iters=10)
    return {"name": "rwkv6_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
            "replaces": "src/repro/kernels/rwkv6_scan.py:78",
            "launches": 0, "max_abs_err": err, "ms": times["ms"],
            "plain_ms": plain_ms, "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None, "device_ms": times["device_ms"],
            "shape": f"B=1 S={prompt_max} H={H} N={N} r/k/v bf16, w f32, "
                     f"{groups} column groups per head",
            "shared_bytes": smem}


# ----------------------------------------------------------------- phase 3
def serve(torch, cfg, flags, params, specs, ecfg, device, instrument=None):
    from repro_torch.core import (DeviceSpec, HostSpec, LMBSystem,
                                  SystemSpec)
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine, SubmitSpec

    model = build_model(cfg, flags, device=device)
    spec = SystemSpec(expanders=1, pool_gib=8,
                      hosts=(HostSpec("server", page_bytes=4096),),
                      devices=(DeviceSpec("gpu0"),))
    system = LMBSystem(spec)
    eng = ServeEngine(model, params, system, ecfg, device_id="gpu0",
                      device=device)
    if instrument is not None:
        instrument(eng)
    rids = [eng.submit(SubmitSpec(prompt=p, max_new_tokens=n))
            for p, n in specs]
    rounds = []
    t0 = time.monotonic()
    while eng.waiting or eng.active:
        t = time.monotonic()
        eng.step()
        rounds.append(time.monotonic() - t)
        if len(rounds) > 10000:
            raise AssertionError("engine did not drain")
    wall = time.monotonic() - t0
    return eng, rids, rounds, wall, system


def free_card(torch) -> float:
    """Drop what earlier phases left (engines hold their params in
    reference cycles) and return the GiB still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2**30


def prompts_for(cfg, lens, news, seed):
    """The workload's prompts, drawn from the model's own vocabulary."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
            for n, m in zip(lens, news)]


def serve_phase(torch, label, cfg, prompts, ecfg, apart=()):
    """Serve ``cfg`` at full width from random bf16 weights drawn from
    seed 0, with the kernels on: a warm-up request (cuBLAS handles, the
    allocator), then the measured run, with the kernels' launch counts and
    the dispatchers' call counts reset just before it and read just after,
    then the breakdown run.  The params are dropped on return."""
    from repro_torch.core.metrics import GLOBAL_METRICS
    from repro_torch.kernels import cuda_build, ops
    from repro_torch.models import build_model
    from repro_torch.models.flags import Flags

    left = free_card(torch)
    if left > 1.0:
        raise AssertionError(f"{left:.2f} GiB of earlier phases still on "
                             "the card")
    torch.cuda.reset_peak_memory_stats()
    flags = Flags(remat=False, use_kernels=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = time.monotonic()
    params = build_model(cfg, flags, device="cuda").init(gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"{label}: serve {cfg.name} full width, {cfg.num_layers} layers, "
          f"{n_params} params bf16, init {time.monotonic() - t:.2f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    eng, _, _, _, system = serve(torch, cfg, flags, params,
                                 [(prompts[0][0][:16], 2)], ecfg, "cuda")
    system.close()
    del eng
    cuda_build.reset_launch_counts()
    calls = ops.dispatch_counts()
    GLOBAL_METRICS.reset()             # the onboard tier's hits and misses
    eng, rids, rounds, wall, system = serve(torch, cfg, flags, params,
                                            prompts, ecfg, "cuda")
    torch.cuda.synchronize()
    launches = cuda_build.launch_counts()
    dispatches = {k: v - calls[k] for k, v in ops.dispatch_counts().items()}
    st = eng.stats()
    reqs = [eng.requests[r] for r in rids]
    if not all(r.state == "done" for r in reqs):
        raise AssertionError(f"not all done: {[r.state for r in reqs]}")
    for r, (_, n) in zip(reqs, prompts):
        if len(r.out_tokens) != n or not all(
                0 <= t < cfg.padded_vocab for t in r.out_tokens):
            raise AssertionError(f"request {r.req_id}: bad tokens")
    c = eng.kv.buf.metrics.tier(eng.kv.buf.name, "onboard")
    gen_tokens = sum(len(r.out_tokens) for r in reqs)
    result = {
        "requests": len(reqs), "generated_tokens": gen_tokens,
        "wall_s": wall, "tokens_per_s": gen_tokens / wall,
        "mean_ttft_s": st["mean_ttft_s"],
        "mean_round_s": sum(rounds) / len(rounds), "rounds": len(rounds),
        "decode_path": st["decode_path"], "paged_rounds": eng.paged_rounds,
        "launches": launches, "dispatches": dispatches,
        "lmb_link_bytes": eng.kv.buf.host.fm.op_bytes(),
        "onboard_hits": c.hits, "onboard_misses": c.misses,
        "kv_page_bytes": eng.kv.buf.page_bytes,
        "lmb_resident_pages_at_end": eng.kv.lmb_resident_pages(),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    system.close()
    del eng
    print("  serve: " + json.dumps(result))
    result["breakdown"] = breakdown_phase(torch, cfg, flags, params, prompts,
                                          ecfg, apart)
    return result


def check_paged(res, cfg) -> None:
    """The LMB main path: paged decode every round, flash every prefill,
    the KV across the link."""
    launches, op_bytes = res["launches"], res["lmb_link_bytes"]
    if res["decode_path"] != "paged" or res["paged_rounds"] <= 0:
        raise AssertionError(f"{cfg.name}: no paged decode round ran")
    for name in PAGED_KERNELS:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    if op_bytes.get("demand", 0) <= 0 or res["onboard_misses"] <= 0:
        raise AssertionError(f"{cfg.name}: the KV never crossed the LMB "
                             "link")


def check_counts(res, cfg, want) -> None:
    """Launch (kernels) and call (dispatchers) counts of the measured run
    against ``want``: {name: count}."""
    got = {**res["dispatches"], **res["launches"]}
    for name, n in want.items():
        if got.get(name, 0) != n:
            raise AssertionError(f"{cfg.name}: {name} ran "
                                 f"{got.get(name, 0)} times, not {n}")
    print(f"  counts as expected: {want}")


def breakdown_phase(torch, cfg, flags, params, prompts, ecfg, apart=()):
    """The serve run again, each stage of the engine timed on the host
    with a device sync after it (so stages do not overlap): where a round's
    time goes.  Not the measured run: the syncs cost a little.  The model
    step is the paged step or, on the dense slot path, the per-request
    decode step; a path's stages that never run stay at 0.  ``apart``
    names model functions, ``(key, module, attribute)``, timed apart inside
    the stage that calls them (the MoE layer, the SSM branch): their
    seconds are part of that stage's."""
    acc = {"prefill": 0.0, "decode_view": 0.0, "model_step": 0.0,
           "commit_decode": 0.0}
    inner = {f"{key}_in_{stage}": 0.0 for key, _, _ in apart
             for stage in ("prefill", "model_step")}
    stage = [None]

    def timed(name, fn, into):
        def run(*args, **kw):
            torch.cuda.synchronize()
            outer, t = stage[0], time.monotonic()
            if into is acc:
                stage[0] = name
            try:
                out = fn(*args, **kw)
                torch.cuda.synchronize()
            finally:
                stage[0] = outer
            key = name if into is acc else f"{name}_in_{outer}"
            into[key] = into.get(key, 0.0) + time.monotonic() - t
            return out
        return run

    def instrument(eng):
        eng._prefill_fn = timed("prefill", eng._prefill_fn, acc)
        if eng._paged_fn is not None:
            eng._paged_fn = timed("model_step", eng._paged_fn, acc)
        eng._decode_fn = timed("model_step", eng._decode_fn, acc)
        eng.kv.decode_view = timed("decode_view", eng.kv.decode_view, acc)
        eng.kv.commit_decode = timed("commit_decode", eng.kv.commit_decode,
                                     acc)

    saved = [(mod, attr, getattr(mod, attr)) for _, mod, attr in apart]
    for (key, mod, attr), (_, _, fn) in zip(apart, saved):
        setattr(mod, attr, timed(key, fn, inner))
    try:
        eng, _, rounds, wall, system = serve(torch, cfg, flags, params,
                                             prompts, ecfg, "cuda",
                                             instrument)
        system.close()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    out = dict(acc)
    out["other"] = wall - sum(acc.values())
    out["wall_s"] = wall
    out["rounds"] = len(rounds)
    if inner:
        out["apart"] = inner
    print("  breakdown (s, summed over the run): " + json.dumps(out))
    return out


def serve_phases(torch, lens, news, prompts) -> dict:
    """Phases 3 to 4c: each model served, checked and dropped in turn;
    returns each one's results by name."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.serve import EngineConfig

    qwen = get_config("qwen2-1.5b")
    ecfg = EngineConfig(decode_slots=8, page_tokens=32, max_seq_len=512,
                        onboard_pages=16)
    served = {}
    # qwen2-1.5b: the LMB main path.  A KV page is 28*2*32*2*128*2 B =
    # 917,504 B; 16 onboard pages hold about a third of the batch's KV
    served["qwen2-1.5b"] = res = serve_phase(torch, "phase 3", qwen, prompts,
                                             ecfg)
    check_paged(res, qwen)
    # rwkv6-7b: one KV page would be 16 MiB; this model stores none
    cfg = get_config("rwkv6-7b")
    served["rwkv6-7b"] = res = serve_phase(
        torch, "phase 4", cfg, prompts_for(cfg, lens, news, 1),
        dataclasses.replace(ecfg, onboard_pages=4))
    if res["decode_path"] != "dense" or res["paged_rounds"] != 0:
        raise AssertionError("rwkv6 left the dense slot path")
    check_counts(res, cfg, {"rwkv6_scan": cfg.num_layers * len(prompts)})
    if res["lmb_link_bytes"]:
        raise AssertionError(f"rwkv6 moved LMB bytes: "
                             f"{res['lmb_link_bytes']}")
    # dbrx-132b at full width, 8 of its 40 layers (a layer is 6.52 GB in
    # bf16, so 40 would be 262 GB); a KV page is 8*2*32*8*128*2 B =
    # 1,048,576 B, and the batch's ~40 pages spill past 16 onboard
    cfg = dataclasses.replace(get_config("dbrx-132b"),
                              num_layers=DBRX_LAYERS)
    served["dbrx-132b"] = res = serve_phase(
        torch, "phase 4b", cfg, prompts_for(cfg, lens, news, 2), ecfg,
        apart=(("moe", moe_mod, "moe_apply"),))
    check_paged(res, cfg)
    check_counts(res, cfg, {
        "paged_attention": cfg.num_layers * res["paged_rounds"],
        "flash_attention": cfg.num_layers * len(prompts)})
    # hymba-1.5b at full width and depth: the dense slot path (its SWA ring
    # and SSM state), its KV in LMB pages of 32*2*32*5*64*2 B = 1,310,720 B
    cfg = get_config("hymba-1.5b")
    served["hymba-1.5b"] = res = serve_phase(
        torch, "phase 4c", cfg, prompts_for(cfg, lens, news, 3), ecfg,
        apart=(("ssm", ssm_mod, "ssm_apply"),))
    if res["decode_path"] != "dense":
        raise AssertionError("hymba left the dense slot path")
    check_counts(res, cfg, {"ssd_scan": cfg.num_layers * len(prompts),
                            "flash_attention": cfg.num_layers * len(prompts)})
    if sum(res["lmb_link_bytes"].values()) <= 0:
        raise AssertionError("hymba's KV never crossed the LMB link")
    free_card(torch)
    return served


def seamless_phase(torch) -> dict:
    """Phase 4d: full-width seamless-m4t-large-v2 in bf16 through the
    port's ``Model`` (the engine refuses encoder-decoder models, as the
    reference's cannot feed them): random weights from seed 0, 8 sources
    of 512 frame embeddings from ``frontend.audio_frames``, a 32-token
    target prefix from the model's vocabulary, then 32 greedy decode
    steps into a cache of 128 slots, the argmax on the card.  A warm-up
    prefill and step first; launch counts are reset just before the
    measured prefill and read after the last step.  The params are
    dropped on return."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import cuda_build, ops
    from repro_torch.models import build_model
    from repro_torch.models import encdec as encdec_mod
    from repro_torch.models.flags import Flags
    from repro_torch.models.frontend import audio_frames

    left = free_card(torch)
    if left > 1.0:
        raise AssertionError(f"{left:.2f} GiB of earlier phases still on "
                             "the card")
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("seamless-m4t-large-v2")
    run = SEAMLESS_RUN
    B, steps = run["batch"], run["steps"]
    model = build_model(cfg, Flags(remat=False, use_kernels=True),
                        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = time.monotonic()
    params = model.init(gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"phase 4d: {cfg.name} full width, {cfg.num_encoder_layers} "
          f"encoder + {cfg.num_layers} decoder layers, {n_params} params "
          f"bf16, init {time.monotonic() - t:.2f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if n_params != SEAMLESS_PARAMS:
        raise AssertionError(f"{n_params} params, not {SEAMLESS_PARAMS}")
    src = audio_frames(gen, B, run["src_len"], cfg.d_model)
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, run["prefix"])).astype(np.int32),
        device="cuda"), "src_emb": src}

    def greedy(logits):
        return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)

    # warm-up at the phase's shapes (cuBLAS handles, the allocator)
    cache = model.init_cache(B, run["cache"], run["src_len"])
    logits, cache = model.prefill(params, batch, cache)
    model.decode_step(params, cache, greedy(logits))
    del cache, logits
    torch.cuda.synchronize()

    encode, enc_s = encdec_mod.encode, [0.0]

    def timed_encode(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = encode(*args, **kw)
        torch.cuda.synchronize()
        enc_s[0] += time.monotonic() - t0
        return out

    cuda_build.reset_launch_counts()
    calls = ops.dispatch_counts()
    encdec_mod.encode = timed_encode
    try:
        t = time.monotonic()
        cache = model.init_cache(B, run["cache"], run["src_len"])
        logits, cache = model.prefill(params, batch, cache)
        torch.cuda.synchronize()
        prefill_s = time.monotonic() - t
    finally:
        encdec_mod.encode = encode
    prefill_calls = 1
    tok = greedy(logits)
    first = logits
    out = [tok]
    t = time.monotonic()
    for _ in range(steps):
        logits, cache = model.decode_step(params, cache, tok)
        tok = greedy(logits)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.monotonic() - t
    launches = cuda_build.launch_counts()
    dispatches = {k: v - calls[k] for k, v in ops.dispatch_counts().items()}
    tokens = torch.cat(out, dim=1).cpu()
    V = cfg.padded_vocab
    if tuple(first.shape) != (B, V) or tuple(logits.shape) != (B, V):
        raise AssertionError(f"logits {tuple(logits.shape)}, not {(B, V)}")
    if not (torch.isfinite(first).all() and torch.isfinite(logits).all()):
        raise AssertionError("seamless logits are not finite")
    if not ((tokens >= 0).all() and (tokens < V).all()):
        raise AssertionError("seamless tokens out of the vocabulary")
    if cache["step"] != run["prefix"] + steps or int(
            (cache["pos"] >= 0).sum()) != B * (run["prefix"] + steps):
        raise AssertionError("seamless decode cache positions are wrong")
    want = {"flash_attention": cfg.num_layers * prefill_calls}
    got = {k: launches.get(k, 0) for k in KERNEL_SOURCES}
    if got != {**dict.fromkeys(KERNEL_SOURCES, 0), **want} or \
            dispatches["flash_attention"] != want["flash_attention"]:
        raise AssertionError(f"{cfg.name}: launches {got}, dispatches "
                             f"{dispatches}, want {want}")
    cross = sum(cache[k].numel() * cache[k].element_size()
                for k in ("cross_k", "cross_v"))
    self_kv = sum(cache[k].numel() * cache[k].element_size()
                  for k in ("k", "v"))
    res = {"params": n_params, "encode_s": enc_s[0],
           "decoder_prefill_s": prefill_s - enc_s[0],
           "prefill_s": prefill_s, "decode_steps": steps,
           "mean_step_s": decode_s / steps,
           "tokens_per_s": B * steps / decode_s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "cross_kv_bytes": cross, "self_kv_bytes": self_kv,
           "launches": launches, "dispatches": dispatches,
           "prefill_calls": prefill_calls,
           "first_tokens": tokens[0, :8].tolist()}
    print("  seamless: " + json.dumps(res))
    print(f"  counts as expected: {want}")
    return res


def encdec_reference_phase(torch) -> None:
    """Phase 5 for reduced seamless-m4t-large-v2 in f32: the card
    (kernels) against the CPU (plain versions) through ``Model`` on the
    same params, source frames and target prefix (13 target tokens into a
    cache of 32, 19 source frames): prefill logits within 1e-5 (TF32
    off) and identical greedy token streams over 8 decode steps."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model
    from repro_torch.models.flags import Flags
    from repro_torch.models.frontend import audio_frames

    cfg = get_config("seamless-m4t-large-v2").reduced()
    flags = Flags(remat=False, use_kernels=True)
    cpu_params = build_model(cfg, flags, device="cpu").init(
        torch.Generator().manual_seed(0))
    gpu_params = _to(cpu_params, "cuda")
    src = audio_frames(torch.Generator().manual_seed(1), 2, 19, cfg.d_model,
                       torch.float32)
    tokens = torch.as_tensor(np.random.default_rng(7).integers(
        1, 100, (2, 13)).astype(np.int32))
    first, streams, last = [], [], []
    for device, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        model = build_model(cfg, flags, device=device)
        lg, cache = model.prefill(
            params, {"tokens": tokens.to(device), "src_emb": src.to(device)},
            model.init_cache(2, 32, 19))
        first.append(lg.cpu())
        tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
        out = [tok]
        for _ in range(8):
            lg, cache = model.decode_step(params, cache, tok)
            tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
            out.append(tok)
        streams.append(torch.cat(out, 1).cpu().tolist())
        last.append(lg.cpu())
    print("phase 5: reduced seamless-m4t-large-v2 f32, card against CPU "
          "plain path, through Model")
    check("prefill logits S=13 src=19", first[1], first[0], 1e-5)
    print(f"  last decode logits: max_abs_err="
          f"{max_err(last[1], last[0]):.3e}")
    if streams[0] != streams[1]:
        raise AssertionError(f"token streams differ: {streams}")
    print(f"  token streams identical ({sum(map(len, streams[0]))} tokens)")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ----------------------------------------------------------------- phase 5
def reference_phase(torch, arch, lengths, max_seq_len):
    """A reduced config in f32: the card (kernels) against the CPU (plain
    versions) on the same params and prompts."""
    import numpy as np
    from repro_torch.configs.base import MOE, get_config
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.flags import Flags
    from repro_torch.serve import EngineConfig

    cfg = get_config(arch).reduced()
    flags = Flags(remat=False, use_kernels=True)
    cpu_params = build_model(cfg, flags, device="cpu").init(
        torch.Generator().manual_seed(0))
    gpu_params = _to(cpu_params, "cuda")
    rng = np.random.default_rng(7)
    specs = [(rng.integers(1, 100, n).astype(np.int32), 6) for n in lengths]
    ecfg = EngineConfig(decode_slots=2, max_seq_len=max_seq_len,
                        page_tokens=8, onboard_pages=4, round_time_s=1e-3)
    streams, op, margins = [], [], []
    route = moe_mod.route
    if cfg.block_type == MOE:
        # the CPU run records, per router call, its smallest margin between
        # the k-th and (k+1)-th logit: where a flip of routing could start
        def recording(p, cfg_, xt):
            out = route(p, cfg_, xt)
            top = torch.topk(out[0], cfg_.top_k + 1, dim=-1).values
            gap = (top[..., -2] - top[..., -1]).reshape(-1)
            i = int(torch.argmin(gap))
            margins.append((float(gap[i]), len(margins), i))
            return out
        moe_mod.route = recording
    try:
        for device, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            eng, rids, _, _, system = serve(torch, cfg, flags, params, specs,
                                            ecfg, device)
            moe_mod.route = route
            streams.append([eng.requests[r].out_tokens for r in rids])
            op.append(eng.kv.buf.host.fm.op_bytes())
            path = eng.stats()["decode_path"]
            system.close()
    finally:
        moe_mod.route = route
    # logits of one prefill of the longest prompt, card against CPU
    tok = torch.as_tensor(max(specs, key=lambda s: len(s[0]))[0][None])
    logits = []
    for device, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        model = build_model(cfg, flags, device=device)
        lg, _ = model.prefill(params, {"tokens": tok.to(device)},
                              model.init_cache(1, max_seq_len))
        logits.append(lg.cpu())
    print(f"phase 5: reduced {arch} f32, card against CPU plain path, "
          f"{path} decode")
    if margins:
        m, call, token = min(margins)
        print(f"  smallest router margin (k-th minus (k+1)-th logit) on the "
              f"CPU: {m:.3e}, layer {call % cfg.num_layers}, token {token} "
              f"of router call {call} (of {len(margins)})")
    check(f"prefill logits S={tok.shape[1]}", logits[1], logits[0], 1e-4)
    if streams[0] != streams[1] or op[0] != op[1]:
        raise AssertionError(f"token streams or link bytes differ: "
                             f"{streams} {op}")
    print(f"  token streams identical ({sum(map(len, streams[0]))} tokens),"
          f" link bytes identical {op[0]}")


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def workload():
    """The serve phases' requests: prompt lengths, new tokens per request
    (16..32) and the decode batch's lengths mid-run (every prompt plus
    half its new tokens)."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = [16, 256, 48, 200, 96, 130, 24, 160]
    news = [int(n) for n in rng.integers(16, 33, len(lens))]
    serve_lengths = [n + m // 2 for n, m in zip(lens, news)]
    return lens, news, serve_lengths, rng


# ----------------------------------------------------------------- phase 6
def _gbps(nbytes: int, s: float) -> float:
    return nbytes / s / 1e9 if s > 0 else float("inf")


def train_phase(torch, card: str) -> dict:
    """6a: full-width qwen2-1.5b trained through the launcher, its
    optimizer state parked in pinned host memory between steps."""
    import math
    from repro_torch.core.offload import PINNED_HOST
    from repro_torch.kernels import cuda_build
    from repro_torch.launch import train

    left = free_card(torch)
    if left > 1.0:
        raise AssertionError(f"{left:.2f} GiB of earlier phases still on "
                             "the card")
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    t = time.monotonic()
    out = train.run("qwen2-1.5b", reduced=False, verbose=False,
                    **TRAIN_RUN)
    total = time.monotonic() - t
    launches = cuda_build.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    state, log = out["state_bytes"], out["step_log"]
    print(f"phase 6a: qwen2-1.5b full width, bf16, {TRAIN_RUN}; optimizer "
          f"state {state:,} B (predicted {QWEN_STATE_BYTES:,}), LMB pool "
          f"{out['pool_gib']} GiB; set-up {total - out['wall_s']:.1f} s "
          f"(params, pinned slab, first page-out), {len(log)} steps "
          f"{out['wall_s']:.1f} s on {card}")
    for rec in log:
        tm, mv = rec["times"], rec["moved"]
        stages = ", ".join(f"{k} {tm[k] * 1e3:.1f}" for k in TRAIN_STAGES)
        print(f"  step {rec['step']}: loss {rec['loss']:.4f}, "
              f"{rec['s'] * 1e3:.1f} ms ({stages} ms); in "
              f"{mv['to_device']:,} B at "
              f"{_gbps(mv['to_device'], tm['page_in']):.1f} GB/s, out "
              f"{mv['to_host']:,} B at "
              f"{_gbps(mv['to_host'], tm['page_out']):.1f} GB/s; parked "
              f"{'/'.join(rec['parked_tiers'])}, device "
              f"{rec['device_bytes'] / 2**30:.2f} GiB")
    print(f"  peak device memory {peak:.2f} GiB; kernel launches "
          f"{launches or 'none'} (the training path runs the plain "
          f"versions, as the reference's)")
    if state != QWEN_STATE_BYTES:
        raise AssertionError(f"state {state} B != {QWEN_STATE_BYTES}")
    for rec in log:
        if rec["moved"] != {"to_device": state, "to_host": state}:
            raise AssertionError(f"step {rec['step']} moved {rec['moved']}")
        if rec["parked_tiers"] != [PINNED_HOST]:
            raise AssertionError(f"step {rec['step']}: state parked in "
                                 f"{rec['parked_tiers']}")
        if not rec["device_bytes"] < state:
            raise AssertionError(f"step {rec['step']}: "
                                 f"{rec['device_bytes']} B on the card "
                                 "between steps")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"losses {out['losses']}")
    if launches:
        raise AssertionError(f"training launched kernels {launches}")
    steady = log[1:] or log
    med = lambda xs: sorted(xs)[len(xs) // 2]
    result = {
        "losses": out["losses"], "state_bytes": state,
        "step_ms": med([r["s"] * 1e3 for r in steady]),
        "stage_ms": {k: med([r["times"][k] * 1e3 for r in steady])
                     for k in TRAIN_STAGES},
        "in_gbps": med([_gbps(state, r["times"]["page_in"])
                        for r in steady]),
        "out_gbps": med([_gbps(state, r["times"]["page_out"])
                         for r in steady]),
        "peak_gib": peak,
        "parked_gib": max(r["device_bytes"] for r in log) / 2**30,
        "setup_s": total - out["wall_s"], "launches": launches}
    del out
    free_card(torch)
    return result


def _param_gap(a, b, lr: float, steps: int) -> float:
    """The largest element gap between two param trees, held to
    PARAM_TOL but for one element in a thousand (each within Adam's
    2 * lr a step)."""
    import torch
    d = torch.cat([(x.float().cpu() - y.float().cpu()).abs().reshape(-1)
                   for x, y in zip(_leaves(a), _leaves(b))])
    worst, past = float(d.max()), int((d > PARAM_TOL).sum())
    if worst > 2 * lr * steps or past > 1e-3 * d.numel():
        raise AssertionError(f"params differ by up to {worst:.3e} ({past} "
                             f"of {d.numel()} past {PARAM_TOL})")
    return worst


def train_reference_phase(torch) -> None:
    """6b: each reduced config in f32 trained 5 steps on the card and on
    the CPU (offload on, grad_accum 2, compression for qwen2) from the
    same params: the same losses and final params."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.models.flags import Flags

    print(f"phase 6b: reduced f32 training, card against CPU, 5 steps "
          f"(losses within {LOSS_TOL:g} relative, params within "
          f"{PARAM_TOL:g})")
    for arch in TRAIN_ARCHS:
        kw = dict(steps=5, global_batch=4, seq_len=32, grad_accum=2,
                  compress_grads=arch == "qwen2-1.5b", offload_opt=True,
                  verbose=False)
        cfg = get_config(arch).reduced()
        params = build_model(cfg, Flags(remat=False), device="cpu").init(
            torch.Generator().manual_seed(0))
        cpu = train.run(arch, device="cpu", init_params=params, **kw)
        gpu = train.run(arch, device="cuda",
                        init_params=_to(params, "cuda"), **kw)
        rel = max(abs(a - b) / abs(b) for a, b in zip(gpu["losses"],
                                                      cpu["losses"]))
        gap = _param_gap(gpu["params"], cpu["params"], 1e-3, 5)
        print(f"  {arch}: losses {[round(x, 5) for x in gpu['losses']]}, "
              f"max rel err {rel:.3e}; params max abs err {gap:.3e}")
        if not rel <= LOSS_TOL:
            raise AssertionError(f"{arch}: losses {gpu['losses']} against "
                                 f"{cpu['losses']}")


def train_profile_phase(torch) -> dict:
    """6d: where a full-width training step's compute goes.  The
    launcher's train step on qwen2-1.5b with its state on the card (no
    paging: the compute part of a 6a step), two steps to warm up, one
    timed, one under ``torch.profiler``: the device's busy time (kernels,
    copies, fills) against the timed step's wall gives the idle share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.models.flags import Flags
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import (StepClock, make_train_step,
                                        opt_state_init)

    cfg = get_config("qwen2-1.5b")
    S, Bg = TRAIN_RUN["seq_len"], TRAIN_RUN["global_batch"]
    model = build_model(cfg, Flags(remat=False, attn_chunk=S))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    opt = opt_state_init(params, True)
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1,
                                              total_steps=6),
                           TRAIN_RUN["grad_accum"], True)
    data = SyntheticLM(DataConfig(cfg.vocab_size, S, Bg))
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch(0).items()}
    for _ in range(2):
        params, opt, _ = step(params, opt, batch)
    clock = StepClock("cuda")
    t = time.perf_counter()
    params, opt, _ = step(params, opt, batch, clock)
    wall = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    by_op = {}
    for e in dev:
        by_op[e.name] = by_op.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:6]
    stages = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in clock.times.items())
    print(f"phase 6d: one qwen2-1.5b train step, state on the card: wall "
          f"{wall:.1f} ms ({stages} ms); device busy {busy:.1f} ms in "
          f"{len(dev)} device operations (profiled step), idle share "
          f"{(1 - busy / wall) if dev else float('nan'):.3f}")
    for name, ms in top:
        print(f"  {ms:8.2f} ms  {name[:100]}")
    if not dev:
        print("  the profiler recorded no device time: not measured")
    result = {"wall_ms": wall, "busy_ms": busy, "ops": len(dev),
              "stage_ms": {k: v * 1e3 for k, v in clock.times.items()}}
    del params, opt, step, prof
    free_card(torch)
    return result


def resume_phase(torch) -> None:
    """6c: a run stopped by the failure injector at step 12 and resumed
    from its step-10 checkpoint gives the uninterrupted run's losses and
    params (reduced qwen2-1.5b on the card, offload and compression on);
    and the loss falls over 30 steps."""
    import shutil
    from repro_torch.launch import train
    from repro_torch.train.checkpoint import latest_step

    kw = dict(steps=20, global_batch=4, seq_len=32, ckpt_every=10,
              verbose=False, device="cuda", offload_opt=True,
              compress_grads=True)
    ref = train.run("qwen2-1.5b", **kw)
    d = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    try:
        try:
            train.run("qwen2-1.5b", ckpt_dir=str(d), fail_at={12}, **kw)
        except RuntimeError as exc:
            if "injected failure at step 12" not in str(exc):
                raise
        else:
            raise AssertionError("the injected failure did not stop the run")
        if latest_step(str(d)) != 10:
            raise AssertionError(f"latest checkpoint {latest_step(str(d))}")
        out = train.run("qwen2-1.5b", ckpt_dir=str(d), **kw)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(out["losses"],
                                                  ref["losses"][10:]))
    gap = _param_gap(out["params"], ref["params"], 1e-3, 10)
    falls = train.run("qwen2-1.5b", steps=30, global_batch=4, seq_len=64,
                      device="cuda", verbose=False)
    print(f"phase 6c: resumed at step 10 after a failure at 12: "
          f"{out['steps']} steps, losses max rel err {rel:.3e} against the "
          f"uninterrupted run, params max abs err {gap:.3e}; 30 steps: "
          f"loss {falls['first_loss']:.4f} -> {falls['final_loss']:.4f}")
    if out["steps"] != 10 or not rel <= LOSS_TOL:
        raise AssertionError(f"resumed {out['losses']} against "
                             f"{ref['losses'][10:]}")
    if not falls["final_loss"] < falls["first_loss"] - 0.1:
        raise AssertionError(f"loss did not fall: {falls['losses']}")


# ----------------------------------------------------------------- phase 7
def sweep_tenants(serve, n, rate_rps, prompt_tokens, max_new_tokens):
    """serve_sweep's mix (benchmarks/run.py): a Poisson tenant and a
    bursty one (bursts of 6 at 10x the mean rate), ``n`` requests each."""
    return [serve.TenantLoad("steady", rate_rps=rate_rps, n_requests=n,
                             prompt_tokens=prompt_tokens,
                             max_new_tokens=max_new_tokens),
            serve.TenantLoad("bursty", rate_rps=rate_rps, n_requests=n,
                             process="bursty", burst_size=6,
                             burst_factor=10.0, prompt_tokens=prompt_tokens,
                             max_new_tokens=max_new_tokens)]


def sweep_run(torch, cfg, flags, params, trace, ecfg, device, *,
              expanders=1, migrate=False):
    """Replay ``trace`` through ``run_sweep`` on a fresh engine whose KV
    pages over ``expanders`` LMB expanders.  ``migrate`` runs one
    ``MigrationEngine`` round (default policy) after every engine step:
    ``run_sweep``'s own loop around a wrapped ``step``.  Each step, and
    each migration round apart, is timed on the host with the device
    synchronised after it.  The kernels' launch counts are reset just
    before the run and read just after."""
    from repro_torch.core import (DeviceSpec, HostSpec, LMBSystem,
                                  SystemSpec)
    from repro_torch.core.metrics import GLOBAL_METRICS
    from repro_torch.kernels import cuda_build
    from repro_torch.models import build_model
    from repro_torch.qos import MigrationEngine
    from repro_torch.serve import ServeEngine, VirtualClock, run_sweep

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    system = LMBSystem(SystemSpec(
        expanders=expanders, pool_gib=8,
        hosts=(HostSpec("server", page_bytes=4096),),
        devices=(DeviceSpec("gpu0"),)))
    clock = VirtualClock()
    eng = ServeEngine(build_model(cfg, flags, device=device), params, system,
                      ecfg, device_id="gpu0", clock=clock, device=device)
    mig = None
    if migrate:
        mig = MigrationEngine(system)
        mig.register(eng.kv.buf)
    rounds, mig_s, reports, prefills = [], [], [], [0]
    step, prefill = eng.step, eng._prefill_fn

    def counted_prefill(*args, **kw):
        prefills[0] += 1
        return prefill(*args, **kw)

    def timed_step():
        t = time.monotonic()
        out = step()
        sync()
        rounds.append(time.monotonic() - t)
        if mig is not None:
            t = time.monotonic()
            reports.append(mig.run_once())
            sync()
            mig_s.append(time.monotonic() - t)
        return out

    eng.step, eng._prefill_fn = timed_step, counted_prefill
    GLOBAL_METRICS.reset()          # the KV store's onboard hits and misses
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    t0 = time.monotonic()
    report = run_sweep(eng, trace, clock)
    sync()
    wall = time.monotonic() - t0
    launches = cuda_build.launch_counts()
    eng.kv.buf.check_invariants()
    reqs = list(eng.requests.values())
    gen = sum(len(r.out_tokens) for r in reqs)
    out = {
        "report": report, "wall_s": wall, "rounds": rounds,
        "streams": {r.req_id: list(r.out_tokens) for r in reqs},
        "states": sorted({r.state for r in reqs}),
        "generated_tokens": gen, "tokens_per_s": gen / wall,
        "paged_rounds": eng.paged_rounds, "prefills": prefills[0],
        "launches": launches, "link_bytes": system.fm.op_bytes(),
        "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if device == "cuda" else None),
        "migration": reports, "migration_s": mig_s,
        "mig_stats": mig.stats() if mig is not None else None,
    }
    system.close()
    return out


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q / 100 * (len(xs) - 1))))]


def print_sweep(label, res, card) -> None:
    """The SweepReport (virtual time) and what the card measured, apart."""
    rep = res["report"]
    tot = dict(rep.totals)
    print(f"  {label}: virtual (modelled: tpu_tiers() link constants, "
          f"pinned {SWEEP_ECFG["round_time_s"] * 1e3:g} ms round; not H100 latency):")
    for line in rep.table().splitlines():
        print(f"    {line}")
    print("    totals " + json.dumps(tot))
    ms = [r * 1e3 for r in res["rounds"]]
    line = {
        "wall_s": res["wall_s"], "rounds": len(ms),
        "round_ms_median": _pct(ms, 50), "round_ms_p99": _pct(ms, 99),
        "tokens_per_s": res["tokens_per_s"],
        "generated_tokens": res["generated_tokens"],
        "peak_mem_gib": res["peak_mem_gib"],
        "lmb_link_bytes": res["link_bytes"],
        "paged_attention": res["launches"].get("paged_attention"),
        "flash_attention": res["launches"].get("flash_attention"),
        "paged_rounds": res["paged_rounds"], "prefills": res["prefills"]}
    if res["mig_stats"] is not None:
        line["migration"] = {
            "rounds_triggered": sum(r.triggered for r in res["migration"]),
            "pages_moved": res["mig_stats"]["pages_moved"],
            "bytes_moved": res["mig_stats"]["bytes_moved"],
            "run_once_s": sum(res["migration_s"]),
            # (pages, from, to) of each round that moved pages
            "moves": [(r.pages_moved, r.src_expander, r.dst_expander)
                      for r in res["migration"] if r.triggered]}
    print(f"    measured on {card}: " + json.dumps(line))


def sweep_phase(torch, card) -> dict:
    """Phase 7a: full-width qwen2-1.5b (bf16, random weights from seed 0)
    through ``build_trace`` and ``run_sweep``: (i) pipelined on one
    expander, (ii) phased on the same trace, (iii) pipelined on two
    expanders with hot-page migration after every step."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model
    from repro_torch.models.flags import Flags
    from repro_torch import serve

    t0 = time.monotonic()
    left = free_card(torch)
    if left > 1.0:
        raise AssertionError(f"{left:.2f} GiB of earlier phases still on "
                             "the card")
    cfg = get_config("qwen2-1.5b")
    flags = Flags(remat=False, use_kernels=True)
    params = build_model(cfg, flags, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    trace = serve.build_trace(sweep_tenants(serve, **SWEEP_LOAD),
                              vocab_size=cfg.vocab_size, seed=0)
    ecfg = serve.EngineConfig(**SWEEP_ECFG)
    print(f"phase 7a: load sweep, {cfg.name} full width bf16, "
          f"{len(trace)} requests over "
          f"{trace[-1].arrival_time_s:.3f} s of virtual time, {SWEEP_LOAD}, "
          f"{SWEEP_ECFG}")
    # warm-up: cuBLAS handles, the allocator, both kernels
    sweep_run(torch, cfg, flags, params, trace[:2], ecfg, "cuda")
    runs = {
        "pipelined": sweep_run(torch, cfg, flags, params, trace, ecfg,
                               "cuda"),
        "phased": sweep_run(torch, cfg, flags, params, trace,
                            dataclasses.replace(ecfg, pipeline=False),
                            "cuda"),
        "migrating": sweep_run(torch, cfg, flags, params, trace, ecfg,
                               "cuda", expanders=2, migrate=True),
    }
    for name, res in runs.items():
        print_sweep(name, res, card)
    check_sweep(runs, cfg, len(trace))
    del params
    free_card(torch)
    print(f"  phase 7a took {time.monotonic() - t0:.1f}s")
    return runs


def check_sweep(runs, cfg, n) -> None:
    """7a's gates: every request done, launches exact, the phased and the
    migrating runs' streams equal to the pipelined one's, pages moved, and
    strictly more exposed link wait phased than pipelined."""
    for name, res in runs.items():
        tot = res["report"].totals
        if res["states"] != ["done"] or tot["done"] != n:
            raise AssertionError(f"{name}: {tot['done']} of {n} done "
                                 f"({res['states']})")
        want = {"paged_attention": cfg.num_layers * res["paged_rounds"],
                "flash_attention": cfg.num_layers * res["prefills"]}
        got = {k: res["launches"].get(k, 0) for k in want}
        if got != want or res["prefills"] != n:
            raise AssertionError(f"{name}: launches {got}, want {want} "
                                 f"({res['prefills']} prefills)")
    base = runs["pipelined"]
    for name in ("phased", "migrating"):
        if runs[name]["streams"] != base["streams"]:
            first = next(r for r in base["streams"]
                         if runs[name]["streams"][r] != base["streams"][r])
            raise AssertionError(f"{name}: request {first}'s stream differs "
                                 "from the pipelined run's")
    if runs["migrating"]["mig_stats"]["pages_moved"] < 1:
        raise AssertionError("migration moved no page")
    wait = {k: runs[k]["report"].totals["exposed_link_wait_s"]
            for k in ("pipelined", "phased")}
    if not wait["phased"] > wait["pipelined"]:
        raise AssertionError(f"exposed link wait not lower pipelined: {wait}")
    print(f"  7a gates hold: {n} done in each run; launches exact; streams "
          f"equal across the three runs; exposed link wait "
          f"{wait['pipelined']:.6g} s pipelined < {wait['phased']:.6g} s "
          "phased (virtual)")


def sweep_reference_phase(torch) -> None:
    """Phase 7b: serve_sweep's exact trace on reduced qwen2-1.5b (f32), on
    the card (kernels) and on the CPU (plain versions) from the same
    params; then the migrating run on two expanders.  The SweepReports,
    the streams and every round's MigrationReport must be equal."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model
    from repro_torch.models.flags import Flags
    from repro_torch import serve

    t0 = time.monotonic()
    cfg = get_config("qwen2-1.5b").reduced()
    flags = Flags(remat=False, use_kernels=True)
    cpu_params = build_model(cfg, flags, device="cpu").init(
        torch.Generator().manual_seed(0))
    params = {"cpu": cpu_params, "cuda": _to(cpu_params, "cuda")}
    trace = serve.build_trace(sweep_tenants(serve, **REDUCED_SWEEP_LOAD),
                              vocab_size=cfg.vocab_size, seed=0)
    ecfg = serve.EngineConfig(**REDUCED_SWEEP_ECFG)
    print(f"phase 7b: reduced {cfg.name} f32, serve_sweep's trace "
          f"({len(trace)} requests), card against CPU")
    for migrate in (False, True):
        got = {}
        for device in ("cpu", "cuda"):
            res = sweep_run(torch, cfg, flags, params[device], trace, ecfg,
                            device, expanders=2 if migrate else 1,
                            migrate=migrate)
            rep = res["report"]
            got[device] = (rep.per_tenant, rep.totals, res["streams"],
                           [(m.pages_moved, m.src_expander, m.dst_expander)
                            for m in res["migration"]])
        if got["cuda"] != got["cpu"]:
            for i, what in enumerate(("per_tenant", "totals", "streams",
                                      "migration reports")):
                if got["cuda"][i] != got["cpu"][i]:
                    raise AssertionError(f"7b: {what} differ, card "
                                         f"{got['cuda'][i]} CPU "
                                         f"{got['cpu'][i]}")
        moved = sum(m[0] for m in got["cpu"][3])
        print(f"  {'migrating' if migrate else 'pipelined'}: SweepReport, "
              f"{sum(map(len, got['cpu'][2].values()))} tokens and "
              f"{len(got['cpu'][3])} migration reports ({moved} pages moved)"
              f" equal, card and CPU; totals {json.dumps(got['cpu'][1])}")
    print(f"  phase 7b took {time.monotonic() - t0:.1f}s")


# ------------------------------------------------------ --against OTHER_DIR
# ----------------------------------------------------------------- phase 8
def dryrun_real_args(torch, model, shape):
    """The arguments of ``build_cell``'s step as real tensors on the card:
    params drawn from seed 0, AdamW's state or the decode cache by the
    port's own init, the batch drawn from the vocabulary."""
    from repro_torch.train.loop import opt_state_init
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    B, S = shape.global_batch, shape.seq_len
    ids = lambda *shp: torch.randint(0, model.cfg.vocab_size, shp,
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)
    if shape.kind == "train":
        return params, opt_state_init(params), {"tokens": ids(B, S),
                                                "labels": ids(B, S)}
    cache = model.init_cache(B, S)
    cache["step"] = torch.zeros((), dtype=torch.int32, device="cuda")
    return params, cache, ids(B, 1)


def dryrun_phase(torch, card: str) -> dict:
    """8a: the port's dry run of qwen2-1.5b x decode_32k on the production
    meshes (host only).  8b: the dry run's prediction for two full-width
    qwen2-1.5b steps on a (1, 1) mesh against the same steps run on the
    card."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import make_train_step

    t0 = time.monotonic()
    for mesh_kind in ("single", "multi"):
        rec = dryrun.run_cell("qwen2-1.5b", "decode_32k", mesh_kind,
                              verbose=False)
        if rec["status"] != "ok":
            raise AssertionError(f"8a {mesh_kind}: {rec.get('error')}\n"
                                 f"{rec.get('trace')}")
        m, r = rec["memory"], rec["roofline"]
        print(f"phase 8a: dry run qwen2-1.5b x decode_32k x {mesh_kind} "
              f"({r['chips']} fake ranks, {r['chip']}): compute "
              f"{r['compute_s'] * 1e3:.4f} ms, memory "
              f"{r['memory_s'] * 1e3:.4f} ms, collective "
              f"{r['collective_s'] * 1e3:.4f} ms, dominant {r['dominant']},"
              f" roofline fraction {r['roofline_fraction']:.6f}, model "
              f"flops {r['model_flops']:.6g}; per device: args "
              f"{m['argument_size_in_bytes']:,} B, out "
              f"{m['output_size_in_bytes']:,} B, peak "
              f"{m['peak_size_in_bytes']:,} B; traced in "
              f"{rec['trace_s']:.1f} s (host), rewrites "
              f"{rec['rewrites']}")
        if mesh_kind == "single" and \
                m["argument_size_in_bytes"] != DRYRUN_ARG_BYTES:
            raise AssertionError(f"argument bytes "
                                 f"{m['argument_size_in_bytes']:,} != "
                                 f"{DRYRUN_ARG_BYTES:,}")
    t_8a = time.monotonic() - t0

    cfg = get_config("qwen2-1.5b")
    mesh = fake_mesh((1, 1), ("data", "model"))
    model = build_model(cfg, dryrun.DRY_FLAGS, device="cuda")
    cells = {}
    for kind, seq, batch, tol in DRYRUN_CELLS:
        shape = ShapeConfig(f"{kind}_{batch}x{seq}", seq, batch, kind)
        t = time.monotonic()
        pred = dryrun.measure_cell(cfg, shape, mesh)
        t_pred = time.monotonic() - t
        terms = dryrun.roofline_of(pred, cfg, shape, 1)
        left = free_card(torch)
        if left > 1.0:
            raise AssertionError(f"{left:.2f} GiB still on the card")
        fn = make_train_step(model, AdamWConfig()) if kind == "train" \
            else model.decode_step
        args = dryrun_real_args(torch, model, shape)
        arg_bytes = dryrun.local_nbytes(args)
        out = fn(*args)                     # warm-up: cuBLAS workspaces
        del out
        times, rise = [], 0
        for _ in range(3):
            if kind == "decode":
                args[1]["step"] = torch.zeros((), dtype=torch.int32,
                                              device="cuda")
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            rise = max(rise, torch.cuda.max_memory_allocated() - base)
            del out
        del args
        step_s = sorted(times)[1]
        mem = pred["memory"]
        err = mem["peak_size_in_bytes"] / rise - 1.0
        print(f"phase 8b: qwen2-1.5b full width bf16 {kind} {batch} x "
              f"{seq}, mesh (1, 1): predicted args "
              f"{mem['argument_size_in_bytes']:,} B, real {arg_bytes:,} B;"
              f" predicted peak {mem['peak_size_in_bytes']:,} B, "
              f"max_memory_allocated rose {rise:,} B ({err:+.2%}, bound "
              f"{tol:.0%}); step {step_s * 1e3:.2f} ms measured, roofline "
              f"{terms.step_time_s * 1e3:.2f} ms ({terms.dominant}-bound, "
              f"{terms.chip.name}), measured/roofline "
              f"{step_s / terms.step_time_s:.2f}; predicted "
              f"{pred['flops']:.6g} flops, {pred['bytes']:.6g} B moved "
              f"(eager, unfused), {len(pred['collectives'])} collectives, "
              f"rewrites {pred['rewrites']}; traced as DTensors in "
              f"{t_pred:.1f} s (host) on {card}")
        if pred["collectives"]:
            raise AssertionError(f"{kind}: one rank issued "
                                 f"{pred['collectives']}")
        if mem["argument_size_in_bytes"] != arg_bytes:
            raise AssertionError(f"{kind}: predicted args "
                                 f"{mem['argument_size_in_bytes']} != real "
                                 f"{arg_bytes}")
        if abs(err) > tol:
            raise AssertionError(f"{kind}: predicted peak "
                                 f"{mem['peak_size_in_bytes']} B, real "
                                 f"rise {rise} B")
        cells[kind] = {"pred": pred, "rise": rise, "step_s": step_s,
                       "roofline_s": terms.step_time_s}
    del model
    free_card(torch)
    dist.destroy_process_group()
    print(f"  phase 8 took {time.monotonic() - t0:.1f}s (8a "
          f"{t_8a:.1f}s)")
    return cells


def time_tree(root: Path) -> int:
    """Build the paged, flash and scan kernels of the checkout at ``root``
    and print their wrappers' times at the main path's shapes as one JSON
    line.  Runs in a process of its own, in which main() put ``root``'s
    sources first on the path before anything imported the port."""
    import torch
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as rw
    for mod in (pa, rw):
        if not Path(mod.__file__).resolve().is_relative_to(root.resolve()):
            raise AssertionError(f"imported {mod.__file__}, not {root}'s")
    cuda_build.build(KERNEL_SOURCES)
    lens, _, serve_lengths, _ = workload()
    paged, flash = main_path_inputs(torch, serve_lengths, max(lens))
    scan = wkv_main_inputs(torch, max(lens))
    print(json.dumps({
        "paged_attention": both_times(
            lambda: pa.paged_attention_cuda(*paged)),
        "flash_attention": both_times(
            lambda: fa.flash_attention_cuda(*flash)),
        "rwkv6_scan": both_times(lambda: rw.rwkv6_scan_cuda(*scan))}))
    return 0


def against(other: Path) -> int:
    """Time another checkout's wrappers and this one's in turns other,
    this, this, other, each in a fresh process, and print each turn."""
    print(card_line())
    for root in (other, ROOT, ROOT, other):
        run = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--time-tree",
             str(root)], capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return 1
        turn = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": str(root), **turn}))
    return 0


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--against", type=Path, metavar="OTHER_CHECKOUT",
                        help="only time this checkout's paged attention, "
                        "flash attention and WKV6 scan wrappers beside "
                        "another's")
    parser.add_argument("--time-tree", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.time_tree is not None:
        sys.path.insert(0, str(args.time_tree / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import numpy as np
        from repro_torch.kernels import cuda_build
    except ImportError as exc:
        print(f"chip_smoke: the port is not here ({exc})", file=sys.stderr)
        return 1
    if args.time_tree is not None:
        return time_tree(args.time_tree)
    if args.against is not None:
        return against(args.against)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    card = card_line()
    print(f"phase 1: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {host_line()}")
    t = time.monotonic()
    logs = cuda_build.build(KERNEL_SOURCES)
    print(f"  built {', '.join(KERNEL_SOURCES)} in "
          f"{time.monotonic() - t:.1f}s")
    for name, log in logs.items():
        print_ptxas(name, log)

    lens, news, serve_lengths, rng = workload()
    # qwen2-1.5b's vocabulary (151,936 ids); the other phases draw theirs
    prompts = [(rng.integers(0, 151936, n).astype(np.int32), m)
               for n, m in zip(lens, news)]

    kernels = kernel_phase(torch, serve_lengths, max(lens))
    kernels.append(rwkv_kernel_phase(torch, max(lens)))
    served = serve_phases(torch, lens, news, prompts)
    seamless = seamless_phase(torch)
    free_card(torch)
    swept = sweep_phase(torch, card)

    for k in kernels:
        by_path = {name: res["launches"][k["name"]]
                   for name, res in served.items()
                   if k["name"] in res["launches"]}
        if k["name"] in seamless["launches"]:
            by_path["seamless-m4t-large-v2"] = \
                seamless["launches"][k["name"]]
        main_path = k.get("path") or (
            "rwkv6-7b" if k["name"] in RWKV_KERNELS else "qwen2-1.5b")
        k["path"] = main_path
        k["launches"] = by_path.get(main_path, 0)
        by_path["qwen2-1.5b load sweep"] = \
            swept["pipelined"]["launches"].get(k["name"], 0)
        k["launches_by_path"] = by_path
    reference_phase(torch, "qwen2-1.5b", (5, 13, 20, 9, 17), 64)
    reference_phase(torch, "rwkv6-7b", (5, 13, 20, 9, 17, 70), 128)
    reference_phase(torch, "dbrx-132b", (5, 13, 20, 9, 17), 64)
    reference_phase(torch, "mixtral-8x22b", (5, 13, 20, 9, 17), 64)
    reference_phase(torch, "hymba-1.5b", (5, 13, 20, 9, 17, 70), 128)
    encdec_reference_phase(torch)
    sweep_reference_phase(torch)
    trained = train_phase(torch, card)
    profiled = train_profile_phase(torch)
    train_reference_phase(torch)
    resume_phase(torch)
    dryrun_phase(torch, card)
    for k in kernels:
        k["launches_by_path"]["qwen2-1.5b training"] = \
            trained["launches"].get(k["name"], 0)

    for name, res in served.items():
        print(f"serve {name}: {res['tokens_per_s']:.1f} tokens/s, mean TTFT "
              f"{res['mean_ttft_s'] * 1e3:.1f} ms, mean round "
              f"{res['mean_round_s'] * 1e3:.2f} ms, peak "
              f"{res['peak_mem_gib']:.2f} GiB, link bytes "
              f"{res['lmb_link_bytes']} on {card}")
    for name, res in swept.items():
        tot = res["report"].totals
        ms = [r * 1e3 for r in res["rounds"]]
        print(f"load sweep qwen2-1.5b {name}: {tot['done']} of "
              f"{tot['requests']} done in {tot['rounds']} rounds, "
              f"{res['tokens_per_s']:.1f} tokens/s, round median "
              f"{_pct(ms, 50):.2f} ms, p99 {_pct(ms, 99):.2f} ms, wall "
              f"{res['wall_s']:.2f} s on {card}; virtual exposed link wait "
              f"{tot['exposed_link_wait_s']:.6g} s (modelled)")
    print(f"seamless-m4t-large-v2: encode {seamless['encode_s'] * 1e3:.1f} "
          f"ms, decoder prefill {seamless['decoder_prefill_s'] * 1e3:.1f} "
          f"ms, mean decode step {seamless['mean_step_s'] * 1e3:.2f} ms, "
          f"{seamless['tokens_per_s']:.1f} tokens/s, peak "
          f"{seamless['peak_mem_gib']:.2f} GiB on {card}")
    stages = ", ".join(f"{k} {v:.1f}" for k, v in
                       trained["stage_ms"].items())
    print(f"train qwen2-1.5b: step {trained['step_ms']:.1f} ms ({stages} "
          f"ms), state {trained['state_bytes']:,} B each way at "
          f"{trained['in_gbps']:.1f} GB/s in, {trained['out_gbps']:.1f} "
          f"GB/s out, peak {trained['peak_gib']:.2f} GiB, parked "
          f"{trained['parked_gib']:.2f} GiB, losses "
          f"{[round(x, 4) for x in trained['losses']]}; state on the "
          f"card: step {profiled['wall_ms']:.1f} ms, device busy "
          f"{profiled['busy_ms']:.1f} ms on {card}")
    print(f"total {time.monotonic() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
