#!/usr/bin/env python3
"""Drive the PyTorch port of LMB on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device and build: the card's name and power limit, then ``nvcc``
     builds every kernel of the main path from ``src/repro_torch/kernels/
     csrc`` (one process per source, all started together);
  2. kernels against their plain PyTorch versions on the card, at the
     serving path's full-width shapes (f32 within 1e-4, bf16 within 2e-2:
     the paged plain version rounds p to bf16, the kernel does not) and at
     a small shape with the edge cases (length 0, lengths on a page
     boundary, unmapped pages holding garbage, a mixed batch,
     ``scale_override=0.0``; a window, GQA and a ragged S for flash), then
     each kernel's time beside its plain version's, its bound and, for
     flash, ``scaled_dot_product_attention`` as a yardstick the port never
     calls;
  3. serve: full-width qwen2-1.5b in bf16 with the kernels on, random
     weights from a seed, KV paged over an LMB tier in pinned host memory
     and spilling to it; launch counts are reset just before and read just
     after this run, and a second run times each engine stage apart;
  4. reference: the reduced qwen2 config in f32 served on the card and on
     the CPU (plain versions, which the tests hold to the JAX reference)
     must give the same logits and token streams.

The last lines are the ``kernels`` JSON, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
KERNEL_SOURCES = ("paged_attention", "flash_attention")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, err: float, tol: float) -> None:
    print(f"  {name}: max_abs_err={err:.3e} (tol {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")


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


def kernel_phase(torch, serve_lengths, prompt_max):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    H, KV, hd, T, MP = 12, 2, 128, 32, 16
    errs = {"paged_attention": 0.0, "flash_attention": 0.0}
    print("phase 2: kernels against their plain versions")
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[1]
        # paged: the decode batch of the serve phase, full width
        args = paged_inputs(torch, gen, dtype, len(serve_lengths), H, KV, hd,
                            T, MP, serve_lengths, L=28, layer=5)
        e = max_err(pa.paged_attention_cuda(*args),
                    pa.paged_attention_plain(*args))
        check(f"paged {tag} full width B={len(serve_lengths)}", e,
              tol[dtype])
        if dtype == torch.bfloat16:
            errs["paged_attention"] = e
        # paged edge cases at hd 16 (the reduced config's head_dim)
        edge = [([0, 9], None), ([8, 12], None), ([0, 4], None),
                ([16, 1, 0, 7], None), ([13, 20], 0.0), ([3], None)]
        for lengths, so in edge:
            B = len(lengths)
            a = paged_inputs(torch, gen, dtype, B, 8, 2, 16, 4, 6, lengths)
            out = pa.paged_attention_cuda(*a, scale_override=so)
            e = max_err(out, pa.paged_attention_plain(*a, scale_override=so))
            check(f"paged {tag} hd16 lengths={lengths} scale={so}", e,
                  tol[dtype])
            for b, n in enumerate(lengths):
                if n == 0 and bool(out[b].abs().max() != 0):
                    raise AssertionError("length-0 row is not zero")
        # flash: the longest prompt at full width, then edge cases
        for (B, S, h, kv, d, window) in ((1, prompt_max, H, KV, hd, None),
                                         (2, 100, 4, 1, 16, 24),
                                         (1, 70, 6, 2, 16, None),
                                         (1, 64, 8, 8, 64, 16)):
            q = torch.randn((B, S, h, d), generator=gen, device="cuda")
            k = torch.randn((B, S, kv, d), generator=gen, device="cuda")
            v = torch.randn((B, S, kv, d), generator=gen, device="cuda")
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            e = max_err(fa.flash_attention_cuda(q, k, v, window=window),
                        fa.flash_attention_plain(q, k, v, window=window))
            check(f"flash {tag} B={B} S={S} H={h} KV={kv} hd={d} "
                  f"window={window}", e, tol[dtype])
            if dtype == torch.bfloat16 and S == prompt_max:
                errs["flash_attention"] = e
    torch.cuda.synchronize()

    # timing at the main path's shapes, bf16
    dt = torch.bfloat16
    esz = 2
    args = paged_inputs(torch, gen, dt, len(serve_lengths), H, KV, hd, T, MP,
                        serve_lengths, L=28, layer=5)
    live = sum(serve_lengths)
    B = len(serve_lengths)
    pa_bytes = (2 * live * KV * hd + 2 * B * H * hd) * esz \
        + args[3].numel() * 4 + B * 4
    pa_flops = 4 * live * H * hd
    pa_bound = max(pa_bytes / HBM_BYTES_PER_S,
                   pa_flops / PEAK_FLOPS["bfloat16"]) * 1e3
    pa_ms = time_ms(lambda: pa.paged_attention_cuda(*args))
    pa_plain_ms = time_ms(lambda: pa.paged_attention_plain(*args))

    S = prompt_max
    q = torch.randn((1, S, H, hd), generator=gen, device="cuda").to(dt)
    k = torch.randn((1, S, KV, hd), generator=gen, device="cuda").to(dt)
    v = torch.randn((1, S, KV, hd), generator=gen, device="cuda").to(dt)
    fa_flops = 4 * (S * (S + 1) // 2) * hd * H
    fa_bytes = (2 * S * H * hd + 2 * S * KV * hd) * esz
    fa_bound_flops = fa_flops / PEAK_FLOPS["bfloat16"]
    fa_bound_bytes = fa_bytes / HBM_BYTES_PER_S
    fa_bound = max(fa_bound_flops, fa_bound_bytes) * 1e3
    fa_ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v))
    fa_plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    lib_err = max_err(F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2),
        fa.flash_attention_plain(q, k, v))
    print(f"  sdpa vs flash plain bf16 S={S}: max_abs_err={lib_err:.3e}")
    return [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:105",
         "launches": 0, "max_abs_err": errs["paged_attention"],
         "ms": pa_ms, "plain_ms": pa_plain_ms, "bound_ms": pa_bound,
         "bound_by": ("bytes" if pa_bytes / HBM_BYTES_PER_S
                      >= pa_flops / PEAK_FLOPS["bfloat16"]
                      else "operations"),
         "library_ms": None,
         "shape": f"B={B} H={H} KV={KV} hd={hd} T={T} MP={MP} "
                  f"live_tokens={live} bf16"},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:94",
         "launches": 0, "max_abs_err": errs["flash_attention"],
         "ms": fa_ms, "plain_ms": fa_plain_ms, "bound_ms": fa_bound,
         "bound_by": ("operations" if fa_bound_flops >= fa_bound_bytes
                      else "bytes"),
         "library_ms": lib_ms,
         "shape": f"B=1 S={S} H={H} KV={KV} hd={hd} causal bf16"},
    ]


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


def serve_phase(torch, prompts):
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import cuda_build
    from repro_torch.models import build_model
    from repro_torch.models.flags import Flags
    from repro_torch.serve import EngineConfig

    cfg = get_config("qwen2-1.5b")
    flags = Flags(remat=False, use_kernels=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = time.monotonic()
    params = build_model(cfg, flags, device="cuda").init(gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"phase 3: serve qwen2-1.5b full width, {n_params} params bf16, "
          f"init {time.monotonic() - t:.2f}s")
    ecfg = EngineConfig(decode_slots=8, page_tokens=32, max_seq_len=512,
                        onboard_pages=16)
    # warm-up (cuBLAS handles, allocator): one short request
    eng, _, _, _, system = serve(torch, cfg, flags, params,
                                 [(prompts[0][0][:16], 2)], ecfg, "cuda")
    system.close()
    del eng
    cuda_build.reset_launch_counts()
    eng, rids, rounds, wall, system = serve(torch, cfg, flags, params,
                                            prompts, ecfg, "cuda")
    torch.cuda.synchronize()
    launches = cuda_build.launch_counts()
    st = eng.stats()
    reqs = [eng.requests[r] for r in rids]
    if not all(r.state == "done" for r in reqs):
        raise AssertionError(f"not all done: {[r.state for r in reqs]}")
    for r, (_, n) in zip(reqs, prompts):
        if len(r.out_tokens) != n or not all(
                0 <= t < cfg.padded_vocab for t in r.out_tokens):
            raise AssertionError(f"request {r.req_id}: bad tokens")
    op_bytes = eng.kv.buf.host.fm.op_bytes()
    c = eng.kv.buf.metrics.tier(eng.kv.buf.name, "onboard")
    gen_tokens = sum(len(r.out_tokens) for r in reqs)
    page_bytes = eng.kv.buf.page_bytes
    result = {
        "requests": len(reqs), "generated_tokens": gen_tokens,
        "wall_s": wall, "tokens_per_s": gen_tokens / wall,
        "mean_ttft_s": st["mean_ttft_s"],
        "mean_round_s": sum(rounds) / len(rounds), "rounds": len(rounds),
        "paged_rounds": eng.paged_rounds, "launches": launches,
        "lmb_link_bytes": op_bytes, "onboard_hits": c.hits,
        "onboard_misses": c.misses, "kv_page_bytes": page_bytes,
        "lmb_resident_pages_at_end": eng.kv.lmb_resident_pages(),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    system.close()
    print("  serve: " + json.dumps(result))
    if eng.paged_rounds <= 0:
        raise AssertionError("no paged decode round ran")
    for name in KERNEL_SOURCES:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    if sum(op_bytes.values()) <= 0 or c.misses <= 0:
        raise AssertionError("the KV never crossed the LMB link")
    result["breakdown"] = breakdown_phase(torch, cfg, flags, params, prompts,
                                          ecfg)
    return result


def breakdown_phase(torch, cfg, flags, params, prompts, ecfg):
    """The serve run again, each stage of the engine timed on the host
    with a device sync after it (so stages do not overlap): where a round's
    time goes.  Not the measured run: the syncs cost a little."""
    acc = {"prefill": 0.0, "decode_view": 0.0, "model_step": 0.0,
           "commit_decode": 0.0}

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t = time.monotonic()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            acc[name] += time.monotonic() - t
            return out
        return run

    def instrument(eng):
        eng._prefill_fn = timed("prefill", eng._prefill_fn)
        eng._paged_fn = timed("model_step", eng._paged_fn)
        eng.kv.decode_view = timed("decode_view", eng.kv.decode_view)
        eng.kv.commit_decode = timed("commit_decode", eng.kv.commit_decode)

    eng, _, rounds, wall, system = serve(torch, cfg, flags, params, prompts,
                                         ecfg, "cuda", instrument)
    system.close()
    out = dict(acc)
    out["other"] = wall - sum(acc.values())
    out["wall_s"] = wall
    out["rounds"] = len(rounds)
    print("  breakdown (s, summed over the run): " + json.dumps(out))
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ----------------------------------------------------------------- phase 4
def reference_phase(torch):
    """Reduced qwen2 in f32: the card (kernels) against the CPU (plain
    versions) on the same params and prompts."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model
    from repro_torch.models.flags import Flags
    from repro_torch.serve import EngineConfig

    cfg = get_config("qwen2-1.5b").reduced()
    flags = Flags(remat=False, use_kernels=True)
    cpu_params = build_model(cfg, flags, device="cpu").init(
        torch.Generator().manual_seed(0))
    gpu_params = _to(cpu_params, "cuda")
    rng = np.random.default_rng(7)
    specs = [(rng.integers(1, 100, n).astype(np.int32), 6)
             for n in (5, 13, 20, 9, 17)]
    ecfg = EngineConfig(decode_slots=2, max_seq_len=64, page_tokens=8,
                        onboard_pages=4, round_time_s=1e-3)
    streams, op = [], []
    for device, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        eng, rids, _, _, system = serve(torch, cfg, flags, params, specs,
                                        ecfg, device)
        streams.append([eng.requests[r].out_tokens for r in rids])
        op.append(eng.kv.buf.host.fm.op_bytes())
        system.close()
    # logits of one prefill + paged decode step, card against CPU
    tok = torch.as_tensor(specs[2][0][None])
    logits = []
    for device, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        model = build_model(cfg, flags, device=device)
        lg, _ = model.prefill(params, {"tokens": tok.to(device)},
                              model.init_cache(1, 64))
        logits.append(lg.cpu())
    print("phase 4: reduced qwen2 f32, card against CPU plain path")
    check("prefill logits", max_err(logits[1], logits[0]), 1e-4)
    if streams[0] != streams[1] or op[0] != op[1]:
        raise AssertionError(f"token streams or link bytes differ: "
                             f"{streams} {op}")
    print(f"  token streams identical ({sum(map(len, streams[0]))} tokens),"
          f" link bytes identical {op[0]}")


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def main() -> int:
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    card = card_line()
    print(f"phase 1: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    t = time.monotonic()
    logs = cuda_build.build(KERNEL_SOURCES)
    print(f"  built {', '.join(KERNEL_SOURCES)} in "
          f"{time.monotonic() - t:.1f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # the serve phase's requests: prompts of 16..256 tokens, 16..32 new
    rng = np.random.default_rng(0)
    lens = [16, 256, 48, 200, 96, 130, 24, 160]
    news = [int(n) for n in rng.integers(16, 33, len(lens))]
    prompts = [(rng.integers(0, 151936, n).astype(np.int32), m)
               for n, m in zip(lens, news)]
    # the decode batch mid-run: every prompt plus half its new tokens
    serve_lengths = [n + m // 2 for n, m in zip(lens, news)]

    kernels = kernel_phase(torch, serve_lengths, max(lens))
    result = serve_phase(torch, prompts)
    for k in kernels:
        k["launches"] = result["launches"].get(k["name"], 0)
    reference_phase(torch)

    print(f"serve: {result['tokens_per_s']:.1f} tokens/s, mean TTFT "
          f"{result['mean_ttft_s'] * 1e3:.1f} ms, mean round "
          f"{result['mean_round_s'] * 1e3:.2f} ms on {card}")
    print(f"total {time.monotonic() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
