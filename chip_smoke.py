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
     absolute: the paged plain version rounds p to bf16 after the
     softmax's division, the paged tensor-core kernel before it and the
     CUDA-core kernel not at all; the flash kernel rounds p to bf16 and its
     plain version does not; each check also prints the largest |plain|,
     since one bf16 step passes 2e-2 from magnitude 4 up), on the paged
     split plan's edges at full width (rows ending inside a split, trailing
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
     port never calls; the paged kernel also at granite-34b's decode
     batch (``GRANITE_DECODE``: B 32, 48 heads on one kv head, rows of
     512-1,600 tokens in 32-token pages, MP 256), its own ``kernels`` row,
     over ``GRANITE_TIMED_LAYERS`` layer views of one pool taken in turn,
     so each call reads its K/V from HBM as a decode step's layers do, and
     checked to run on tensor cores; the paged kernel at
     k-exaone-236b-a23b's decode batch (``EXAONE_DECODE``: B 32, 64 heads
     on 8 kv heads, rows of 1,024-2,368 tokens), a full layer (window 0)
     and a windowed one (128), held within a tenth of the output's mean
     magnitude (a page left out of a row must miss that), and its held
     experts' CUDA kernels (``EXAONE_EXPERTS``: 8 of 128 experts, top-8)
     at the decode batch and a 1,536-token prompt, beside the same sums
     through ``torch._grouped_mm`` (``library_ms``), each checked against
     its plain version and given a ``kernels`` row whose launches are
     phase 4j's (``python3 chip_smoke.py --exaone`` runs these rows and
     phase 4j alone).  Paged and flash are also checked at
     dbrx-132b's
     shapes (48 heads over 8 KV heads), granite-34b's (48 over 1),
     chameleon-34b's (64 over 8) and command-r-plus-104b's (96 over 8),
     paged at h2o-danube-3-4b's heads and head_dim 120 (32 over 8) and on
     the small edge-case set at head_dim 120, flash at hymba-1.5b's (25
     over 5, head_dim 64, window 1024, S = 256 and 1100), at
     h2o-danube-3-4b's prefill (32 over 8, head_dim 120, window 4096, S =
     256 and 4,200, where the window cuts; its own ``kernels`` row at S =
     256), on head_dim 120's edge cases (a ragged S, a window across a
     tile edge) and at seamless-m4t-large-v2's decoder prefill (B = 8, S
     = 32, 16 heads over 16 KV heads, head_dim 64), which gets its own
     ``kernels`` row; and both kernels at every head_dim
     ``cuda_build.head_dim_ok`` admits (16, 24, ..., 256), in both
     dtypes: paged at B 3, 2 KV heads of 2, T 8, MP 5 on a row of length
     0, a row ending mid-page before unmapped columns of garbage pages
     and a row using every column, flash causal at S 70;
  3. serve qwen2-1.5b: full width in bf16 with the kernels on, random
     weights from a seed, KV paged over an LMB tier in pinned host memory
     and spilling to it; launch counts are reset just before and read just
     after this run, and a second run times each engine stage apart.
     The breakdown also times each LMB burst of the executor (the card
     synchronised around it) and prints ``decode_view`` split into those
     bursts and the rest, with the reads' and writes' GB/s.
     Every paged serve phase (3, 4b, 4f-4h) runs the engine as it comes:
     each batch size's first round eager, then the paged step captured
     as one CUDA graph per batch size when the capture rule says
     (``serve/staged.CaptureRule``; the first batch size met twice at its
     second round) and replayed, its launch counts exact through
     replays, and fails unless the eager rounds (each batch size's first
     and those the rule left eager) and replays together are its paged
     rounds.  Every serve phase's fresh engine meets each prompt length
     once, so its prefills run eagerly, on the engine's static prefill
     cache;
  3s. qwen2-1.5b (full) and dbrx-132b (full width, 8 of 40 layers)
     served eager (``staged=False``) and staged, the same params and
     prompts, each engine twice (the second run times the model step per
     round, the device synchronised around it): equal streams, link
     bytes, onboard hits and misses and launch counts; prints captures
     and replays, the step per round and tokens/s side by side (three
     fresh engines' first runs each, staged over eager); one replay
     traced with ``torch.profiler`` must hold one paged split and one
     combine kernel a layer, and gives dbrx-132b's MoE share of it; the
     second run meets each prompt length again, so it captures the
     first length's prefill graph and those the rule buys, reported
     apart;
  3d. the dense slot path (each request alone at B = 1 against its own
     cache) likewise: rwkv6-7b and h2o-danube-3-4b at full width and
     depth, phase 3's prompt lengths, served eager and staged (one CUDA
     graph per decode slot), each engine twice: equal streams, link
     bytes, hits and misses, launch and dispatch counts (``rwkv6_scan`` or
     flash layers x prompts, paged none); each slot's first step eager,
     a slot captured by the rule (the first slot stepped twice at its
     second step) and replayed after; prints the model step per decode
     step eager beside replayed, first-run tokens/s of two fresh pairs of
     engines and one slot replay's traced device time and operation count (the
     second run's prefill captures reported apart, as in 3s);
  3p. prefill staged (one CUDA graph per prompt length, all writing into
     the engine's one static prefill cache): qwen2-1.5b (paged, flash in
     the graphs), rwkv6-7b (the scan in the graphs) and hymba-1.5b (flash
     and the SSD scan) at full width in bf16, phase 3's engine and 8
     prompt lengths with 4 new tokens each, served three times through
     one engine, staged and eager: each pass's streams, and the link
     bytes, hits, misses, launch and dispatch counts of the three, equal;
     flash 28 and 32 and the scan 32 launches a prompt; pass 1 all eager,
     pass 2 the first length captured, every other length as the rule
     says; prints eager and
     replayed prefill (median ms a prompt, synchronised), captures,
     replays and their host time, the prefill graphs' pool bytes, pass
     3's mean TTFT and tokens/s and each engine's peak memory;
  3q. ``examples/quickstart_torch.py`` on the card (the L2P buffer's
     onboard pages on the card, its LMB tier in pinned host memory) and on
     the CPU, in this process: equal L2P statistics and fabric snapshot;
  3t. the LMB tier under stress: a ``LinkedBuffer`` of 16 pages over 4
     onboard, at qwen2-1.5b's KV page (917,504 B, 300 operations) and
     chameleon-34b's (6,291,456 B, 200), driven through seeded scalar and
     batched reads and writes (waves), pages freed and held again and
     prefetch bursts, on the card (every burst on the copy streams, never
     waited for on the host) and on the CPU (modelling mode): every
     read's fingerprint, every page, the LMB pools' bytes after a sync,
     hits, misses, link bytes, residency and prefetch counters equal;
  3w. reduced qwen2-1.5b in f32, 6 requests through 4 decode slots over 4
     onboard pages (every view waves), on the card and on the CPU: equal
     streams, link bytes, hits, misses, residency and modelled waits, and
     every pool's rows within 1e-4;
  Every dense slot serve phase (4, 4c, 4e, 4i, and phase 5's dense
     configs on the card) runs the engine as it comes, staged, and fails
     unless each slot's first step ran eagerly, its second captured and
     every later one replayed;
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
  4e-4i. the configs first served on the card, each like phase 3 (the
     same engine and prompt lengths, bf16 weights from seed 0, the
     kernels on), each confirming its params' bytes from
     ``abstract_params`` before init and failing unless its peak leaves 4
     GiB of the card free: 4e h2o-danube-3-4b (full, 7.68 GB; window
     4096, so the dense slot path: flash 24 x prefills, no paged launch;
     one more request of 4,200 prompt tokens and 64 new, whose prefill
     passes the window and whose decode wraps the 4,096-slot ring), 4f
     granite-34b (full, 88 layers, 67.32 GB; MQA, GELU MLP, LMB-paged:
     paged 88 x rounds, flash 88 x prompts), 4g chameleon-34b (full, 48
     layers, 67.51 GB; qk-norm, LMB-paged), 4h command-r-plus-104b (full
     width, 16 of 64 layers, 56.62 GB; the 256,000-row tied readout,
     LMB-paged), 4i mixtral-8x22b (full width, 10 of 56 layers, 50.49 GB;
     MoE on the dense slot path, the MoE layer timed apart);
  4j. k-exaone-236b-a23b at full width, its dense layer and one LLLG
     period, 8 of 128 experts held, like phase 3: LMB-paged, the paged
     kernel 5 x rounds on tensor cores (4 x rounds windowed), flash 5 x
     prompts, the expert kernels 4 x (prompts + rounds);
  5. reference: each reduced config in f32 (qwen2-1.5b, rwkv6-7b,
     dbrx-132b, mixtral-8x22b, hymba-1.5b, granite-34b, h2o-danube-3-4b,
     command-r-plus-104b, chameleon-34b, and h2o-danube-3-4b at its
     head_dim of 120, the one reduced case in which the kernels run at
     120) served on the card and on the
     CPU (plain versions, which the tests hold to the JAX reference) must
     give the same logits, token streams and link bytes; reduced
     seamless-m4t-large-v2 the same prefill logits (within 1e-5) and
     greedy token streams through ``Model``;
  6. training through ``repro_torch.launch.train`` (no kernel: the
     reference trains with ``use_kernels=False``, and the kernels have no
     backward).  6a: full-width qwen2-1.5b in bf16, 6 steps of 8 x 256
     tokens in 2 microbatches, int8 error-feedback compression, its
     24,702,574,596 B of optimizer state parked in pinned host memory
     between steps; run three times: staged and streamed (step 0 eager,
     step 1 captured as one CUDA graph, steps 2-5 replayed; each leaf
     paged in on the H2D copy stream from the step's start and out on
     the D2H copy stream once updated, beside the compute, inside the
     graph), staged and serial (the page moves in series with the step),
     then eager; each step's mode and time (a serial eager step's
     page-in, forward and backward, compression, AdamW and page-out
     apart), the bytes moved each way (which must equal the state's),
     the tier of every parked leaf (which must be pinned host), device
     memory allocated between steps (which must be under the state's
     size) and reserved, the graph pool's bytes and each run's peak,
     every loss finite; per staged run the median of the untraced
     replays, the capture step and step 5 traced with ``torch.profiler``;
     streamed must equal serial (losses, params, state) and eager
     (losses, params) bit for bit.  6d: one step with the state on the
     card traced, eager and replayed: wall, device busy time, operations,
     idle share and the gaps between operations; then 6a's traced
     replays with the state parked: H2D, D2H and compute busy time and
     the time copies ran beside compute, which must be above zero in the
     streamed schedule.  6b: five reduced configs in f32 trained 5
     steps staged on the card and eagerly on the CPU from the same params
     must give the same losses (1e-5 relative) and params.  6c: a staged
     run stopped by the failure injector and resumed from its checkpoint
     gives the uninterrupted run's losses, and the loss falls over 30
     steps.
  7. the load sweep through ``repro_torch.serve.loadgen`` (after phase 4i
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
     prints the measured step time beside the roofline's and their ratio,
     and the train step also its time replayed through
     ``StagedTrainStep``.
  9. last: a host sync injected into the staged prefill (reduced
     qwen2-1.5b), then into the staged dense slot step (reduced
     h2o-danube-3-4b), then into the staged train step (reduced
     qwen2-1.5b through the launcher), then into the staged paged step
     (reduced qwen2-1.5b), must make the engine or the launcher raise at
     capture (a prompt length's second prefill, a slot's second step, the
     second train step, the second round at a batch size), with no graph
     made and no eager call run instead.

Each phase's prompts are drawn from its model's vocabulary, and each
serve phase starts from a card that the previous one's params have left.

The last lines are the ``kernels`` JSON (each kernel's launches on the
training path too, none, on the load sweep's run (i) and through phase
3p's staged engines, replays included), the card's name and power
limit, and ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --against OTHER_CHECKOUT

times the paged, flash and WKV6 scan wrappers of another checkout of the
port (for example the parent commit, unpacked with ``git archive``) and of
this one at the main path's bf16 shapes, the paged wrapper also at
granite-34b's decode batch (``paged_attention_granite``, phase 2's row),
both ways, in four fresh processes (other, this, this, other), and prints
one JSON line per turn.

    python3 chip_smoke.py --dense-staged hymba-1.5b,mixtral-8x22b

builds the kernels and runs phase 3d alone for the configs named (of
rwkv6-7b, h2o-danube-3-4b, hymba-1.5b and mixtral-8x22b at 10 of its 56
layers), and prints no result line.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
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
KERNEL_SOURCES = ("paged_attention", "flash_attention", "rwkv6_scan",
                  "expert_ffn", "mla_decode")
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
#: h2o-danube-3-4b's attention (H, KV, hd) and window: the one head_dim
#: (120) that is not a multiple of 16
H2O_ATTN = (32, 8, 120, 4096)
#: the attention (H, KV, hd) of the configs phases 4f-4h serve paged:
#: granite-34b's MQA (48 heads over 1 KV head: six head chunks of 8),
#: chameleon-34b's and command-r-plus-104b's (12 heads a KV head: chunks
#: of 8 and 4)
GRANITE_ATTN = (48, 1, 128)
#: granite-34b's decode batch in the benchmark's completion cell: (B, page
#: tokens T, page-table width MP, shortest and longest row), and the layer
#: views of one pool phase 2 times it over
GRANITE_DECODE = (32, 32, 256, 512, 1600)
GRANITE_TIMED_LAYERS = 8
#: k-exaone-236b-a23b's attention (H, KV, hd) and window, its decode batch
#: in the doc-chat cell (B, T, MP, shortest and longest row), and its
#: expert layer on one chip (d_model, d_ff, experts, top_k, held) with
#: the prompt length its prefill row times
EXAONE_ATTN = (64, 8, 128)
EXAONE_WINDOW = 128
EXAONE_DECODE = (32, 32, 128, 1024, 2368)
EXAONE_EXPERTS = (6144, 2048, 128, 8, 8)
EXAONE_PROMPT = 1536
#: its paged rows' tolerance, a share of the plain output's mean magnitude
EXAONE_PAGED_TOL = 0.1
#: phase 4j: k-exaone-236b-a23b served at full width, its dense layer and
#: one LLLG period (every kind of layer once), 8 of 128 experts held
EXAONE_SERVE_LAYERS = 5
EXAONE_SERVE_HELD = 8
#: deepseek-v3's latent attention (heads, cached row width, value width),
#: its decode batch in the reasoning cell (B, T, MP, shortest and longest
#: row) and the prompt its flash row times at q/k 192 and v 128
DEEPSEEK_MLA = (128, 576, 512)
DEEPSEEK_DECODE = (64, 32, 168, 1024, 5375)
DEEPSEEK_PROMPT = 3072
CHAMELEON_ATTN = (64, 8, 128)
COMMAND_R_ATTN = (96, 8, 128)
#: phase 4e's one long request: prompt tokens (past the 4,096-token
#: window) and new tokens
H2O_LONG = (4200, 64)
#: phase 3s: fresh engines, eager and staged, whose first runs' tokens/s
#: are compared in pairs, the order alternating
FRESH_PAIRS = 3
#: phase 3d: the dense slot configs served eager and staged, each with its
#: depth (``None``: full) and prompts' seed, and fresh engines' pairs; the
#: ones ``--dense-staged`` may name besides (mixtral-8x22b at phase 4i's
#: depth)
DENSE_STAGED = {"rwkv6-7b": (None, 12), "h2o-danube-3-4b": (None, 13),
                "hymba-1.5b": (None, 14), "mixtral-8x22b": (10, 15)}
DENSE_STAGED_RUN = ("rwkv6-7b", "h2o-danube-3-4b")
DENSE_FRESH_PAIRS = 2
#: phase 3p: the staged prefill's configs at full width, each with its
#: prompts' seed and the kernel its prefill launches once a layer; phase
#: 3's prompt lengths served ``PREFILL_PASSES`` times through one engine
#: (pass 1 eager, pass 2 captures, pass 3 replays), with few new tokens,
#: since prefill is what the phase measures
PREFILL_STAGED = (("qwen2-1.5b", 16, "flash_attention"),
                  ("rwkv6-7b", 17, "rwkv6_scan"),
                  ("hymba-1.5b", 18, "flash_attention"))
PREFILL_NEW_TOKENS = 4
PREFILL_PASSES = 3
#: phase 3s: name parts of cuBLAS's GEMM kernels on Hopper (nvjet),
#: CUTLASS's and older cuBLAS's
GEMM_KERNELS = ("nvjet", "gemm", "xmma")
#: phase 2's head_dim sweep: every value the kernels' rule admits
#: (multiples of 8 from 16 to 256), paged at (B, H, KV, T, MP, lengths)
#: and flash causal at (B, S, H, KV)
SWEEP_HEAD_DIMS = tuple(range(16, 257, 8))
SWEEP_PAGED = (3, 4, 2, 8, 5, [0, 13, 40])
SWEEP_FLASH = (1, 70, 4, 2)
#: phases 4e-4i, the configs first served on the card: (label, config,
#: layers, parameter bytes in bf16 from ``Model.abstract_params``).  The
#: depth cuts follow dbrx-132b's budget (8 of 40 layers, 53.4 GB): full
#: command-r-plus-104b would be 208 GB, full mixtral-8x22b 281 GB
NEW_SERVES = (
    ("phase 4e", "h2o-danube-3-4b", 24, 7_678_295_040),
    ("phase 4f", "granite-34b", 88, 67_322_929_152),
    ("phase 4g", "chameleon-34b", 48, 67_514_695_680),
    ("phase 4h", "command-r-plus-104b", 16, 56_624_726_016),
    ("phase 4i", "mixtral-8x22b", 10, 50_485_125_120))
#: the least device memory a serve phase's peak must leave free
MIN_FREE_GIB = 4.0
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
#: the replay each staged 6a run traces (6d reads the streamed one's)
TRAIN_TRACE_STEP = 5
#: 6a's three runs: the staged step streamed and serial, the eager step
TRAIN_MODES = (("streamed", dict(staged=True, streamed=True,
                                 trace_step=TRAIN_TRACE_STEP)),
               ("serial", dict(staged=True, streamed=False,
                               trace_step=TRAIN_TRACE_STEP)),
               ("eager", dict(staged=False)))
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
    q, pool, table, lens = paged_pool(torch, gen, dtype, B, H, KV, hd, T, MP,
                                      lengths, L, garbage)
    return q, pool[:, layer, 0], pool[:, layer, 1], table, lens


def paged_pool(torch, gen, dtype, B, H, KV, hd, T, MP, lengths, L,
               garbage=True):
    """q, the [P, L, 2, T, KV, hd] pool, the page table and the lengths
    of ``paged_inputs``."""
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
    return (q, pool, table.to(dev),
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
        return pa.split_plan(B, KV, mp, T=T, G=H // KV, sm_count=sms)

    errs = {"paged_attention": 0.0, "flash_attention": 0.0,
            "flash_seamless": 0.0, "flash_h2o": 0.0}
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
        dplan = pa.split_plan(B, kv, MP, T=T, G=h // kv, sm_count=sms)
        check(f"paged {tag} dbrx-132b B={B} H={h} KV={kv} plan={dplan}",
              pa.paged_attention_cuda(*args),
              pa.paged_attention_plain(*args), tol[dtype])
        # paged at the decode batch of the configs phases 4f-4h serve (MQA:
        # 48 heads in three m16 tiles; 12 heads a KV head in one) and
        # at h2o-danube-3-4b's heads and head_dim 120, which no registered
        # config pages but the reference's kernel takes
        for name, (h, kv, d) in (("granite-34b", GRANITE_ATTN),
                                 ("chameleon-34b", CHAMELEON_ATTN),
                                 ("command-r-plus-104b", COMMAND_R_ATTN),
                                 ("h2o heads", H2O_ATTN[:3])):
            args = paged_inputs(torch, gen, dtype, B, h, kv, d, T, MP,
                                serve_lengths)
            cplan = pa.split_plan(B, kv, MP, T=T, G=h // kv,
                                  sm_count=sms)
            check(f"paged {tag} {name} B={B} H={h} KV={kv} hd={d} MP={MP} "
                  f"plan={cplan}", pa.paged_attention_cuda(*args),
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
        # paged edge cases at hd 16 (the reduced configs' head_dim) and
        # 120 (idle lanes: 15 chunks a row in bf16, 30 in f32)
        edge = [([0, 9], None), ([8, 12], None), ([0, 4], None),
                ([16, 1, 0, 7], None), ([13, 20], 0.0), ([3], None)]
        for (lengths, so), d in ((e, d) for d in (16, 120) for e in edge):
            B = len(lengths)
            a = paged_inputs(torch, gen, dtype, B, 8, 2, d, 4, 6, lengths)
            out = pa.paged_attention_cuda(*a, scale_override=so)
            check(f"paged {tag} hd{d} lengths={lengths} scale={so}", out,
                  pa.paged_attention_plain(*a, scale_override=so),
                  tol[dtype])
            for b, n in enumerate(lengths):
                if n == 0 and bool(out[b].abs().max() != 0):
                    raise AssertionError("length-0 row is not zero")
        # flash: the longest prompt at full width (qwen2-1.5b, dbrx-132b,
        # granite-34b, chameleon-34b, command-r-plus-104b, hymba-1.5b with
        # its window of 1024 and h2o-danube-3-4b with its window of 4096,
        # and each past its window), then edge cases: S not a multiple of
        # the 32-row q tile or the 64-key tile, windows that cross tile
        # edges, B = 2, head dims 16/64/128/256 and the padded ones between
        # (32 -> 64, 96 and 120 -> 128, 144 -> 256), not causal
        hh, hkv, hd_h, hwin = HYMBA_ATTN
        h2h, h2kv, h2d, h2win = H2O_ATTN
        for (B, S, h, kv, d, window, causal) in (
                (1, prompt_max, H, KV, hd, None, True),
                (*SEAMLESS_FLASH, None, True),
                (1, prompt_max, *DBRX_ATTN, None, True),
                (1, prompt_max, *GRANITE_ATTN, None, True),
                (1, prompt_max, *CHAMELEON_ATTN, None, True),
                (1, prompt_max, *COMMAND_R_ATTN, None, True),
                (1, prompt_max, hh, hkv, hd_h, hwin, True),
                (1, 1100, hh, hkv, hd_h, hwin, True),
                (1, prompt_max, h2h, h2kv, h2d, h2win, True),
                (1, H2O_LONG[0], h2h, h2kv, h2d, h2win, True),
                (1, 100, 4, 2, 120, None, True),
                (2, 70, 4, 1, 120, 40, True),
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
            if dtype == torch.bfloat16 and (S, h, d) == (prompt_max, h2h,
                                                         h2d):
                errs["flash_h2o"] = e
        head_dim_sweep(torch, gen, dtype, tol[dtype])
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
    h2o = tuple(torch.randn((1, prompt_max, h, h2d), generator=gen,
                            device="cuda").to(torch.bfloat16)
                for h in (h2h, h2kv, h2kv))
    granite = granite_paged_row(torch, pa)
    return [*exaone_rows(torch, pa), *deepseek_rows(torch),
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
        granite,
        flash_row(torch, F, fa, (q, k, v), errs["flash_attention"],
                  "qwen2-1.5b"),
        flash_row(torch, F, fa, seamless, errs["flash_seamless"],
                  "seamless-m4t-large-v2"),
        flash_row(torch, F, fa, h2o, errs["flash_h2o"], "h2o-danube-3-4b",
                  window=h2win),
    ]


def granite_decode_inputs(torch):
    """granite-34b's decode batch (``GRANITE_DECODE``) in bf16 from a fixed
    seed: q, one (K, V) view per layer of a ``GRANITE_TIMED_LAYERS``-layer
    pool, the page table and the lengths."""
    import numpy as np
    B, T, MP, lo, hi = GRANITE_DECODE
    H, KV, hd = GRANITE_ATTN
    lengths = [int(n) for n in
               np.random.default_rng(6).integers(lo, hi + 1, B)]
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, pool, table, lens = paged_pool(torch, gen, torch.bfloat16, B, H, KV,
                                      hd, T, MP, lengths,
                                      GRANITE_TIMED_LAYERS)
    views = [(pool[:, i, 0], pool[:, i, 1])
             for i in range(GRANITE_TIMED_LAYERS)]
    return q, views, table, lens


def cycled(fn, views):
    """A call of ``fn(k, v)`` on the next layer view in turn: a graph of
    many calls reads each layer's pages from HBM, not from L2."""
    turn = itertools.count()
    return lambda: fn(*views[next(turn) % len(views)])


def granite_paged_row(torch, pa) -> dict:
    """The paged kernel's ``kernels`` row at granite-34b's decode batch:
    checked against the plain version (bf16, 2e-2) and to run on tensor
    cores, then both times over the layer views in turn, the plain
    version's time and the bound (live K/V read once)."""
    from repro_torch.kernels import cuda_build
    q, views, table, lens = granite_decode_inputs(torch)
    B, T, MP, _, _ = GRANITE_DECODE
    H, KV, hd = GRANITE_ATTN
    before = cuda_build.launch_counts().get(pa.MMA_LAUNCHES, 0)
    err = check(f"paged bfloat16 granite-34b decode B={B} H={H} KV={KV} "
                f"T={T} MP={MP}",
                pa.paged_attention_cuda(q, *views[0], table, lens),
                pa.paged_attention_plain(q, *views[0], table, lens), 2e-2)
    if cuda_build.launch_counts().get(pa.MMA_LAUNCHES, 0) != before + 1:
        raise AssertionError("granite-34b's paged call did not run on "
                             "tensor cores")
    live = int(lens.sum())
    nbytes = (2 * live * KV * hd + 2 * B * H * hd) * 2 + 4 * B * MP + 4 * B
    flops = 4 * live * H * hd
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = flops / PEAK_FLOPS["bfloat16"]
    times = both_times(cycled(
        lambda k, v: pa.paged_attention_cuda(q, k, v, table, lens), views))
    plan = pa.split_plan(B, KV, MP, T=T, G=H // KV,
                         sm_count=pa.sm_count(q.device))
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:106",
            "launches": 0, "max_abs_err": err, "ms": times["ms"],
            "plain_ms": time_ms(lambda: pa.paged_attention_plain(
                q, *views[0], table, lens), iters=5, repeats=3),
            "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None, "device_ms": times["device_ms"],
            "path": "granite-34b",
            "shape": f"B={B} H={H} KV={KV} hd={hd} T={T} MP={MP} "
                     f"live_tokens={live} bf16, plan {plan}, "
                     f"{GRANITE_TIMED_LAYERS} layer views in turn"}


def exaone_rows(torch, pa) -> list:
    """The ``kernels`` rows of k-exaone-236b-a23b, their launches taken
    from phase 4j's serve run (``path`` k-exaone-236b-a23b, counted under
    each row's ``counter``): the paged kernel at its decode batch over
    ``GRANITE_TIMED_LAYERS`` layer views in turn, for a full layer and a
    windowed one, and the held experts' kernels at the decode batch and at
    ``EXAONE_PROMPT`` tokens, each checked against its plain version.  A
    paged row is held within ``EXAONE_PAGED_TOL`` of the plain output's
    mean magnitude (its bf16 rounding is a few thousandths of it), and the
    plain output with one page of a row left out must miss that tolerance:
    a dropped page cannot pass.  The expert rows' ``library_ms`` is the
    same sums through ``torch._grouped_mm`` over the same sorted rows
    (:func:`grouped_mm_route`), None where the card's torch lacks it or
    refuses the shapes.  The bounds: a paged row reads each row's attended
    K/V once; an expert row reads the weights of the held experts some
    pair reaches, x and the output once, against the pairs' operations."""
    import numpy as np
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import expert_ffn as ef
    B, T, MP, lo, hi = EXAONE_DECODE
    H, KV, hd = EXAONE_ATTN
    lengths = [int(n) for n in np.random.default_rng(8).integers(lo, hi + 1,
                                                                 B)]
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, pool, table, lens = paged_pool(torch, gen, torch.bfloat16, B, H, KV,
                                      hd, T, MP, lengths,
                                      GRANITE_TIMED_LAYERS)
    views = [(pool[:, i, 0], pool[:, i, 1])
             for i in range(GRANITE_TIMED_LAYERS)]
    rows = []
    for window in (0, EXAONE_WINDOW):
        name = (f"paged bfloat16 k-exaone-236b-a23b decode B={B} H={H} "
                f"KV={KV} MP={MP} window={window}")
        counts = cuda_build.launch_counts()
        got = pa.paged_attention_cuda(q, *views[0], table, lens,
                                      window=window)
        after = cuda_build.launch_counts()
        want = pa.paged_attention_plain(q, *views[0], table, lens,
                                        window=window)
        # row 0 a page shorter: its last 32 keys left out (a window
        # slides back over the 32 before it)
        short = lens.clone()
        short[0] -= T
        dropped = pa.paged_attention_plain(q, *views[0], table, short,
                                           window=window)
        tol = EXAONE_PAGED_TOL * float(want.float().abs().mean())
        err = check(name, got, want, tol)
        miss = max_err(dropped[:1], want[:1])
        print(f"    a page dropped from row 0 reads {miss:.3e} "
              f"(tol {tol:.3e})")
        if not miss > tol:
            raise AssertionError(f"{name}: a dropped page passes the "
                                 f"tolerance ({miss} <= {tol})")
        if (after.get(pa.MMA_LAUNCHES, 0) != counts.get(pa.MMA_LAUNCHES, 0)
                + 1 or after.get(pa.WINDOWED_LAUNCHES, 0)
                != counts.get(pa.WINDOWED_LAUNCHES, 0) + bool(window)):
            raise AssertionError("k-exaone-236b-a23b's paged call: not on "
                                 "tensor cores, or its window not counted")
        live = sum(min(n, window) if window else n for n in lengths)
        nbytes = (2 * live * KV * hd + 2 * B * H * hd) * 2 + 4 * B * MP \
            + 4 * B
        flops = 4 * live * H * hd
        times = both_times(cycled(
            lambda k, v: pa.paged_attention_cuda(q, k, v, table, lens,
                                                 window=window), views))
        plan = pa.split_plan(B, KV, pa.window_columns(MP, T, window), T=T,
                             G=H // KV, sm_count=pa.sm_count(q.device))
        rows.append({
            "name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:106",
            "counter": pa.WINDOWED_LAUNCHES if window else "paged_attention",
            "launches": None, "max_abs_err": err, "ms": times["ms"],
            "plain_ms": time_ms(lambda: pa.paged_attention_plain(
                q, *views[0], table, lens, window=window), iters=5,
                repeats=3),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                            flops / PEAK_FLOPS["bfloat16"]) * 1e3,
            "bound_by": "bytes", "library_ms": None,
            "device_ms": times["device_ms"],
            "path": "k-exaone-236b-a23b",
            "shape": f"B={B} H={H} KV={KV} hd={hd} T={T} MP={MP} "
                     f"window={window} attended_tokens={live} bf16, plan "
                     f"{plan}, {GRANITE_TIMED_LAYERS} layer views in turn"})
    del pool, views
    D, Fd, E, K, held = EXAONE_EXPERTS
    g = torch.Generator(device="cuda").manual_seed(9)
    w = [torch.randn(shape, generator=g, device="cuda").mul_(
        shape[1] ** -0.5).to(torch.bfloat16)
        for shape in ((held, D, Fd), (held, D, Fd), (held, Fd, D))]
    for tokens in (B, EXAONE_PROMPT):
        x = torch.randn((tokens, D), generator=g, device="cuda").to(
            torch.bfloat16)
        ids = torch.rand((tokens, E), generator=g, device="cuda").topk(
            K, dim=-1).indices
        gates = torch.rand((tokens, K), generator=g, device="cuda")
        args = (x, ids, gates, *w)
        want = ef.expert_ffn_plain(*args)
        got = ef.expert_ffn_cuda(*args)
        err = max_err(got, want)
        scale = float(want.abs().max())
        print(f"  expert_ffn k-exaone-236b-a23b tokens={tokens} row tile "
              f"{ef.row_tile(tokens)}: max_abs_err={err:.3e} of "
              f"max|plain|={scale:.3g}")
        if not err <= 2e-2 * scale:
            raise AssertionError(f"expert_ffn at {tokens} tokens: {err}")
        pairs = int((ids < held).sum())
        reached = int(torch.unique(ids[ids < held]).numel())
        nbytes = reached * 3 * D * Fd * 2 + tokens * D * 2 * 2
        flops = 2 * 3 * D * Fd * pairs
        times = both_times(lambda: ef.expert_ffn_cuda(*args))
        rows.append({
            "name": ef.LAUNCHES, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/expert_ffn.cu",
            "replaces": "none (the capacity dispatch of models/moe.py)",
            "counter": ef.LAUNCHES,
            "launches": None, "max_abs_err": err, "ms": times["ms"],
            "plain_ms": time_ms(lambda: ef.expert_ffn_plain(*args), iters=5,
                                repeats=3),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                            flops / PEAK_FLOPS["bfloat16"]) * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / PEAK_FLOPS["bfloat16"]
                         else "operations"),
            "library_ms": grouped_mm_route(torch, args, want),
            "device_ms": times["device_ms"],
            "path": "k-exaone-236b-a23b",
            "shape": f"T={tokens} D={D} d_ff={Fd} {held} of {E} experts "
                     f"held, top-{K}: {pairs} pairs on {reached} experts"})
    return rows


def deepseek_rows(torch) -> list:
    """The ``kernels`` rows of deepseek-v3 (no serve phase runs it, so
    their launches are None): the latent decode kernels at the reasoning
    cell's decode batch over ``GRANITE_TIMED_LAYERS`` layer views of one
    pool in turn, rows of every length from ``DEEPSEEK_DECODE``'s range
    and a few at page and tile edges, and flash at q/k 192, v 128 over a
    ``DEEPSEEK_PROMPT``-token prompt at 128 heads, each checked against
    its plain version within 2e-2 (bf16).  The bounds: each row's cached
    rows read once, q and the output; flash's q, k, v and output once
    against its causal operations."""
    import numpy as np
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_decode as md
    B, T, MP, lo, hi = DEEPSEEK_DECODE
    H, W, DV = DEEPSEEK_MLA
    lengths = [int(n) for n in np.random.default_rng(10).integers(
        lo, hi + 1, B)]
    lengths[:8] = [1, 31, 32, 33, 63, 64, 65, 0]
    gen = torch.Generator(device="cuda").manual_seed(10)
    L = GRANITE_TIMED_LAYERS
    pool = torch.randn((B * MP, L, T, W), generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    table = torch.randperm(B * MP, generator=gen, device="cuda").to(
        torch.int32).view(B, MP)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn((B, H, W), generator=gen, device="cuda").to(
        torch.bfloat16)
    scale = 0.135234
    views = [pool[:, i] for i in range(L)]

    def call(pages):
        return md.mla_decode_cuda(q, pages, table, lens, scale=scale,
                                  v_width=DV)
    err = check(f"mla_decode deepseek-v3 decode B={B} H={H} T={T} MP={MP}",
                call(views[0]), md.mla_decode_plain(
                    q, views[0], table, lens, scale=scale, v_width=DV),
                2e-2)
    live = sum(lengths)
    nbytes = (live * W + B * H * (W + DV)) * 2 + 4 * B * MP + 4 * B
    flops = live * H * 2 * (W + DV)
    times = both_times(cycled(call, [(v,) for v in views]))
    rows = [{
        "name": md.LAUNCHES, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mla_decode.cu",
        "replaces": "none (latent attention: the JAX package has none)",
        "launches": None, "max_abs_err": err, "ms": times["ms"],
        "plain_ms": time_ms(lambda: md.mla_decode_plain(
            q, views[0], table, lens, scale=scale, v_width=DV), iters=3,
            repeats=2),
        "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                        flops / PEAK_FLOPS["bfloat16"]) * 1e3,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= flops / PEAK_FLOPS["bfloat16"] else "operations"),
        "library_ms": None, "device_ms": times["device_ms"],
        "path": "deepseek-v3",
        "shape": f"B={B} H={H} row={W} v={DV} T={T} MP={MP} "
                 f"live_tokens={live} bf16, plan "
                 f"{md.split_plan(B, H, MP, sm_count=md.sm_count(q.device))}"
                 f", {L} layer views in turn"}]
    del pool, views
    S = DEEPSEEK_PROMPT
    qk = [torch.randn((1, S, H, 192), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2)]
    v = torch.randn((1, S, H, 128), generator=gen, device="cuda").to(
        torch.bfloat16)
    args = (*qk, v)
    err = check(f"flash bfloat16 deepseek-v3 S={S} H={H} q/k 192 v 128",
                fa.flash_attention_cuda(*args, scale=scale),
                fa.flash_attention_plain(*args, scale=scale), 2e-2)
    flops = 2 * H * (192 + 128) * S * (S + 1) / 2
    nbytes = 2 * S * H * (192 + 128) * 2
    times = both_times(lambda: fa.flash_attention_cuda(*args, scale=scale))
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:94",
        "counter": fa.SPLIT_WIDTH_LAUNCHES,
        "launches": None, "max_abs_err": err, "ms": times["ms"],
        "plain_ms": time_ms(lambda: fa.flash_attention_plain(
            *args, scale=scale), iters=2, repeats=2),
        "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                        flops / PEAK_FLOPS["bfloat16"]) * 1e3,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= flops / PEAK_FLOPS["bfloat16"] else "operations"),
        "library_ms": None, "device_ms": times["device_ms"],
        "path": "deepseek-v3",
        "shape": f"B=1 S={S} H={H} KV={H} q/k 192 v 128 causal bf16"})
    return rows


def grouped_mm_route(torch, args, want):
    """Device ms of the expert sums through ``torch._grouped_mm`` over the
    pairs sorted as ``expert_ffn_cuda`` sorts them (rows gathered by
    token, both products of the first matrix in one grouped call against
    the gate and up weights side by side, ``silu(g) u``, the second, each
    row times its gate, summed per token by ``index_add_``), from a
    replayed CUDA graph as the kernels' ``device_ms``; checked against the
    plain version as the kernels are.  None, with the reason printed,
    where the card's torch has no ``_grouped_mm`` or refuses the call."""
    import torch.nn.functional as F
    from repro_torch.kernels import expert_ffn as ef
    x, ids, gates, wg, wu, wd = args
    if not hasattr(torch, "_grouped_mm"):
        print("    torch._grouped_mm: not in this torch")
        return None
    T, K = ids.shape
    held, D, Fd = wg.shape
    order, offs, _, _ = ef.sort_pairs(ids, held)
    n = int(offs[-1])
    pair = order[:n].long()
    tok = pair // K
    ends = offs[1:].contiguous()
    gu = torch.cat([wg, wu], dim=2)
    g = gates.reshape(-1)[pair].float()[:, None]

    def run():
        h = torch._grouped_mm(x[tok], gu, offs=ends)
        h = F.silu(h[:, :Fd]) * h[:, Fd:]
        y = torch._grouped_mm(h, wd, offs=ends)
        return torch.zeros((T, D), dtype=torch.float32,
                           device=x.device).index_add_(0, tok, y.float() * g)
    try:
        err = max_err(run(), want)
    except (RuntimeError, TypeError, ValueError, NotImplementedError) as exc:
        print(f"    torch._grouped_mm refused: {str(exc).splitlines()[0]}")
        return None
    try:
        ms, how = graph_ms(run), "from a graph"
    except RuntimeError as exc:
        ms, how = time_ms(run), f"as issued (no graph: {str(exc)[:80]})"
    print(f"    torch._grouped_mm: {ms:.4f} ms a call {how}, "
          f"max_abs_err={err:.3e}")
    if not err <= 2e-2 * float(want.abs().max()):
        raise AssertionError(f"torch._grouped_mm route: {err}")
    return ms


def head_dim_sweep(torch, gen, dtype, tol: float) -> None:
    """Both kernels against their plain versions at every head_dim
    ``cuda_build.head_dim_ok`` admits (``SWEEP_HEAD_DIMS``), at small
    shapes: paged on ``SWEEP_PAGED``'s edge set (a row of length 0, a row
    ending mid-page before three unmapped columns of garbage pages, a row
    using every column), flash causal at ``SWEEP_FLASH``'s ragged S.
    Every value runs before any failure raises, so one run names all the
    values that fail."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    tag = str(dtype).split(".")[1]
    if [d for d in range(300) if cuda_build.head_dim_ok(d)] != \
            list(SWEEP_HEAD_DIMS):
        raise AssertionError("the sweep's head_dims are not the rule's")
    B, H, KV, T, MP, lengths = SWEEP_PAGED
    fB, fS, fH, fKV = SWEEP_FLASH
    worst = {"paged": 0.0, "flash": 0.0}
    failed = []
    for d in SWEEP_HEAD_DIMS:
        a = paged_inputs(torch, gen, dtype, B, H, KV, d, T, MP, lengths)
        out = pa.paged_attention_cuda(*a)
        q, k, v = (torch.randn((fB, fS, h, d), generator=gen,
                               device="cuda").to(dtype)
                   for h in (fH, fKV, fKV))
        for name, got, want in (
                ("paged", out, pa.paged_attention_plain(*a)),
                ("flash", fa.flash_attention_cuda(q, k, v),
                 fa.flash_attention_plain(q, k, v))):
            err = max_err(got, want)
            worst[name] = max(worst[name], err)
            if not (err <= tol and bool(torch.isfinite(got).all())):
                failed.append(f"{name} hd{d} ({err:.3e})")
        if bool(out[0].abs().max() != 0):
            failed.append(f"paged hd{d} (length-0 row not zero)")
    print(f"  head_dim sweep {tag}, {len(SWEEP_HEAD_DIMS)} values "
          f"{SWEEP_HEAD_DIMS[0]}..{SWEEP_HEAD_DIMS[-1]}: paged B={B} H={H} "
          f"KV={KV} T={T} MP={MP} lengths={lengths} max_abs_err="
          f"{worst['paged']:.3e}; flash B={fB} S={fS} H={fH} KV={fKV} "
          f"causal max_abs_err={worst['flash']:.3e} (tol {tol:g}); "
          f"failed: {failed or 'none'}")
    if failed:
        raise AssertionError(f"head_dim sweep {tag}: {failed}")


def flash_row(torch, F, fa, qkv, err, path, window=None) -> dict:
    """The flash kernel's ``kernels`` row at one path's prefill shape
    (bf16, causal, the path's window): both times, the plain version's,
    the bound (the visible keys' products only), and
    ``scaled_dot_product_attention``'s times and its error against the
    plain version (causal, or with the window as a boolean mask where it
    cuts)."""
    q, k, v = qkv
    B, S, H, hd = q.shape
    KV = k.shape[2]
    W = S if window is None else min(window, S)
    visible = W * (W + 1) // 2 + (S - W) * W   # keys seen, summed over q
    flops = 4 * B * visible * hd * H
    nbytes = (2 * B * S * H * hd + 2 * B * S * KV * hd) * q.element_size()
    by_ops = flops / PEAK_FLOPS["bfloat16"]
    by_bytes = nbytes / HBM_BYTES_PER_S
    times = both_times(lambda: fa.flash_attention_cuda(q, k, v,
                                                       window=window))
    qt, kt, vt = (x.transpose(1, 2) for x in qkv)
    mask = None
    if W < S:
        pos = torch.arange(S, device=q.device)
        mask = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - W)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              is_causal=mask is None,
                                              enable_gqa=True)
    lib = both_times(sdpa)
    lib_err = max_err(sdpa().transpose(1, 2),
                      fa.flash_attention_plain(q, k, v, window=window))
    print(f"  sdpa vs flash plain bf16 B={B} S={S} H={H} KV={KV} hd={hd} "
          f"window={window}: max_abs_err={lib_err:.3e}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:94",
            "launches": 0, "max_abs_err": err, "ms": times["ms"],
            "plain_ms": time_ms(lambda: fa.flash_attention_plain(
                q, k, v, window=window)),
            "bound_ms": max(by_ops, by_bytes) * 1e3,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "library_ms": lib["ms"], "device_ms": times["device_ms"],
            "library_device_ms": lib["device_ms"], "path": path,
            "shape": f"B={B} S={S} H={H} KV={KV} hd={hd} causal"
                     f"{'' if window is None else f' window={window}'} "
                     "bf16"}


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
def make_engine(cfg, flags, params, ecfg, device, staged=True):
    """The serve phases' engine over one LMB expander of 8 GiB (pages of
    4 KiB); ``staged=False`` (phase 3s) runs the paged step eagerly.
    Returns (engine, system)."""
    from repro_torch.core import (DeviceSpec, HostSpec, LMBSystem,
                                  SystemSpec)
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    system = LMBSystem(SystemSpec(
        expanders=1, pool_gib=8, hosts=(HostSpec("server", page_bytes=4096),),
        devices=(DeviceSpec("gpu0"),)))
    eng = ServeEngine(build_model(cfg, flags, device=device), params, system,
                      ecfg, device_id="gpu0", device=device, staged=staged)
    return eng, system


def drain(eng, specs):
    """Submit ``specs`` (prompt, new tokens) and step ``eng`` until it is
    idle.  Returns (request ids, each round's seconds, wall seconds)."""
    from repro_torch.serve import SubmitSpec

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
    return rids, rounds, time.monotonic() - t0


def serve(torch, cfg, flags, params, specs, ecfg, device, instrument=None):
    eng, system = make_engine(cfg, flags, params, ecfg, device)
    if instrument is not None:
        instrument(eng)
    rids, rounds, wall = drain(eng, specs)
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


def serve_phase(torch, label, cfg, prompts, ecfg, apart=(),
                param_bytes=None, inspect=None):
    """Serve ``cfg`` at full width from random bf16 weights drawn from
    seed 0, with the kernels on: a warm-up request (cuBLAS handles, the
    allocator), then the measured run, with the kernels' launch counts and
    the dispatchers' call counts reset just before it and read just after,
    then the breakdown run.  With ``param_bytes``, the params' bytes are
    read from ``Model.abstract_params`` first and must equal it, and the
    measured run's peak must leave ``MIN_FREE_GIB`` of the card free.
    ``inspect(engine, requests)`` looks at the measured run before the
    engine is dropped.  The params are dropped on return."""
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
    if param_bytes is not None:
        abstract = build_model(cfg, flags, device="cuda").abstract_params()
        nbytes = sum(p.numel() * p.element_size()
                     for p in _leaves(abstract))
        print(f"{label}: {cfg.name}, {cfg.num_layers} layers: {nbytes:,} B "
              f"of bf16 params (abstract_params; expected "
              f"{param_bytes:,})")
        if nbytes != param_bytes:
            raise AssertionError(f"{cfg.name}: {nbytes} B of params, not "
                                 f"{param_bytes}")
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
        "staged": eng.staged.stats() if eng.staged else None,
        "staged_prefill": prefill_stats(eng),
        "launches": launches, "dispatches": dispatches,
        "lmb_link_bytes": eng.kv.buf.host.fm.op_bytes(),
        "onboard_hits": c.hits, "onboard_misses": c.misses,
        "kv_page_bytes": eng.kv.buf.page_bytes,
        "lmb_resident_pages_at_end": eng.kv.lmb_resident_pages(),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    if inspect is not None:
        inspect(eng, reqs)
    system.close()
    del eng, reqs
    print("  serve: " + json.dumps(result))
    if param_bytes is not None:
        total = torch.cuda.get_device_properties(0).total_memory / 2**30
        free = total - result["peak_mem_gib"]
        print(f"  peak {result['peak_mem_gib']:.2f} of {total:.2f} GiB, "
              f"{free:.2f} GiB free at peak")
        if free < MIN_FREE_GIB:
            raise AssertionError(f"{cfg.name}: {free:.2f} GiB free at peak,"
                                 f" under {MIN_FREE_GIB}")
    result["breakdown"] = breakdown_phase(torch, cfg, flags, params, prompts,
                                          ecfg, apart)
    return result


def check_paged(res, cfg) -> None:
    """The LMB main path: paged decode every round, flash every prefill,
    the KV across the link."""
    launches, op_bytes = res["launches"], res["lmb_link_bytes"]
    if res["decode_path"] != "paged" or res["paged_rounds"] <= 0:
        raise AssertionError(f"{cfg.name}: no paged decode round ran")
    st = res["staged"]
    if not st or st["captures"] < 1 or st["replays"] < 1 or \
            st["eager_calls"] != len(st["calls"]) + st["eager_repeats"] or \
            st["eager_calls"] + st["replays"] != res["paged_rounds"]:
        raise AssertionError(f"{cfg.name}: the paged step did not run "
                             f"through captured graphs: {st}")
    for name in PAGED_KERNELS:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    if op_bytes.get("demand", 0) <= 0 or res["onboard_misses"] <= 0:
        raise AssertionError(f"{cfg.name}: the KV never crossed the LMB "
                             "link")


def check_slots(res, cfg) -> None:
    """The dense slot path staged: each slot's first step ran eagerly, a
    slot stepped again ran eagerly or was captured as the capture rule
    says (at least one was), and every other step replayed."""
    st = res["staged"]
    steps = list(st["calls"].values()) if st else []
    if not st or res["decode_path"] != "dense" or st["replays"] < 1 or \
            st["eager_calls"] != len(steps) + st["eager_repeats"] or \
            not 1 <= st["captures"] <= sum(n > 1 for n in steps) or \
            st["replays"] != sum(steps) - st["eager_calls"]:
        raise AssertionError(f"{cfg.name}: the dense slot step did not run "
                             f"through captured graphs: {st}")


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
    seconds are part of that stage's.  Nothing is timed apart inside a
    staged step, paged or dense slot (``..._in_model_step`` stays 0
    there): a replay calls no Python, and a capture must not sync; phases
    3s and 3d read the MoE share of a replay from its trace instead.  A
    staged prefill is timed apart where it runs eagerly (each prompt
    length's first: here every prefill, the lengths being distinct) and
    skipped while it is captured."""
    acc = {"prefill": 0.0, "decode_view": 0.0, "model_step": 0.0,
           "commit_decode": 0.0}
    inner = {f"{key}_in_{stage}": 0.0 for key, _, _ in apart
             for stage in ("prefill", "model_step")}
    stage, staged = [None], [False]

    def timed(name, fn, into):
        def run(*args, **kw):
            if into is not acc and (
                    (stage[0] == "model_step" and staged[0])
                    or torch.cuda.is_current_stream_capturing()):
                return fn(*args, **kw)    # captured or replayed: no sync
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

    bursts = {}

    def burst(kind, fn, ex):
        # an executor burst against a pinned LMB pool, timed with the card
        # synchronised around it, charged to the engine stage running it
        def run(pool, slots, *rest):
            if not ex.streams.moves(pool):
                return fn(pool, slots, *rest)
            torch.cuda.synchronize()
            t = time.monotonic()
            out = fn(pool, slots, *rest)
            torch.cuda.synchronize()
            into = bursts.setdefault(stage[0] or "other", dict.fromkeys(
                ("read_s", "read_bytes", "write_s", "write_bytes"), 0))
            into[f"{kind}_s"] += time.monotonic() - t
            into[f"{kind}_bytes"] += len(slots) * pool[0].numel() * \
                pool.element_size()
            return out
        return run

    def instrument(eng):
        ex = eng.kv.buf.executor
        ex._read_pages = burst("read", ex._read_pages, ex)
        ex._write_pages = burst("write", ex._write_pages, ex)
        # the staged step of either path: the paged one or the slots'
        staged[0] = eng.staged is not None
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
    if eng.staged is not None:
        # host time of the captures: part of model_step, once per batch
        # size the capture rule buys in the run
        out["capture_s_in_model_step"] = eng.staged.capture_s
    if eng.staged_prefill is not None:
        # and part of prefill, once per prompt length the rule buys
        out["capture_s_in_prefill"] = eng.staged_prefill.capture_s
    if inner:
        out["apart"] = inner
    if bursts:
        out["bursts"] = bursts
    print("  breakdown (s, summed over the run): " + json.dumps(out))
    if "decode_view" in bursts:
        print("  " + burst_text(out))
    return out


def burst_text(bd: dict) -> str:
    """``decode_view`` split into the executor's LMB bursts (reads and
    writes, the card synchronised around each) and the rest, with each
    direction's rate, and ``commit_decode``'s bursts."""
    def rate(b, kind):
        return _gbps(b[f"{kind}_bytes"], b[f"{kind}_s"])
    dv = bd["bursts"]["decode_view"]
    cd = bd["bursts"].get("commit_decode")
    text = (f"decode_view {bd['decode_view']:.3f} s: executor bursts "
            f"{dv['read_s'] + dv['write_s']:.3f} s (reads "
            f"{dv['read_bytes']:,} B in {dv['read_s']:.3f} s, "
            f"{rate(dv, 'read'):.1f} GB/s; writes {dv['write_bytes']:,} B "
            f"in {dv['write_s']:.3f} s, {rate(dv, 'write'):.1f} GB/s), rest "
            f"{bd['decode_view'] - dv['read_s'] - dv['write_s']:.3f} s")
    if cd:
        text += (f"; commit_decode {bd['commit_decode']:.3f} s, bursts "
                 f"{cd['read_s'] + cd['write_s']:.3f} s (reads "
                 f"{cd['read_bytes']:,} B, writes {cd['write_bytes']:,} B)")
    return text


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
    check_slots(res, cfg)
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
    check_slots(res, cfg)
    check_counts(res, cfg, {"ssd_scan": cfg.num_layers * len(prompts),
                            "flash_attention": cfg.num_layers * len(prompts)})
    if sum(res["lmb_link_bytes"].values()) <= 0:
        raise AssertionError("hymba's KV never crossed the LMB link")
    free_card(torch)
    return served


def staged_run(torch, cfg, flags, params, prompts, ecfg, staged) -> dict:
    """Phase 3s's and 3d's work on one engine, eager or staged:
    ``prompts`` served twice.  The first run is measured as a user meets
    it (counts reset just before it and read just after; a staged engine
    runs each batch size's, or on the dense slot path each slot's, first
    step eagerly and captures its graph when the capture rule says); the
    second serves the same prompts again with the model step timed per
    call (a paged round, or one request's dense step), the device
    synchronised around it (a staged engine replays, and captures what
    the rule buys now; its eager steps are timed apart).  A staged
    engine's replay is then traced (:func:`replay_trace`)."""
    from repro_torch.core.metrics import GLOBAL_METRICS
    from repro_torch.kernels import cuda_build, ops

    eng, system = make_engine(cfg, flags, params, ecfg, "cuda", staged)

    def run():
        rounds0 = eng.paged_rounds
        rids, _, wall = drain(eng, prompts)
        torch.cuda.synchronize()
        reqs = [eng.requests[r] for r in rids]
        if not all(r.state == "done" for r in reqs):
            raise AssertionError(f"not all done: {[r.state for r in reqs]}")
        streams = [list(r.out_tokens) for r in reqs]
        gen = sum(len(s) for s in streams)
        # every token after a request's first (its prefill's) is one
        # decode step of that request
        return {"streams": streams, "wall_s": wall,
                "tokens_per_s": gen / wall,
                "paged_rounds": eng.paged_rounds - rounds0,
                "decode_steps": gen - len(streams)}

    GLOBAL_METRICS.reset()             # the onboard tier's hits and misses
    cuda_build.reset_launch_counts()
    calls = ops.dispatch_counts()
    first = run()
    tier = eng.kv.buf.metrics.tier(eng.kv.buf.name, "onboard")
    first.update(
        launches=cuda_build.launch_counts(),
        dispatches={k: v - calls[k]
                    for k, v in ops.dispatch_counts().items()},
        link_bytes=dict(eng.kv.buf.host.fm.op_bytes()),
        hits=tier.hits, misses=tier.misses,
        staged=eng.staged.stats() if eng.staged else None,
        staged_prefill=prefill_stats(eng))
    attr = "_paged_fn" if eng._use_paged else "_decode_fn"
    step_s, capture_s, eager_s, fn = [], [], [], getattr(eng, attr)

    def timed(*args):
        st = eng.staged
        before = (st.captures, st.eager_calls) if st else None
        torch.cuda.synchronize()
        t = time.monotonic()
        out = fn(*args)
        torch.cuda.synchronize()
        if st is None:
            step_s.append(time.monotonic() - t)
        else:
            (capture_s if st.captures > before[0] else
             eager_s if st.eager_calls > before[1] else
             step_s).append(time.monotonic() - t)
        return out

    setattr(eng, attr, timed)
    second = run()
    second["step_ms"] = sorted(x * 1e3 for x in step_s)
    second["capture_ms"] = [x * 1e3 for x in capture_s]
    second["eager_ms"] = [x * 1e3 for x in eager_s]
    second["staged"] = eng.staged.stats() if eng.staged else None
    second["staged_prefill"] = prefill_stats(eng)
    out = {"first": first, "second": second}
    if eng.staged is not None:
        out["trace"] = replay_trace(torch, eng, cfg, flags, params)
    system.close()
    del eng
    return out


def prefill_stats(eng):
    """A staged engine's prefill counts (None for an eager engine)."""
    return eng.staged_prefill.stats() if eng.staged_prefill else None


def prefill_text(staged) -> str:
    """What the staged prefill did in phase 3s's or 3d's two runs: the
    second run meets each prompt length again, so it captures the first
    length and those the rule buys (time that the second run's tokens/s
    includes)."""
    p1, p2 = staged["first"]["staged_prefill"], \
        staged["second"]["staged_prefill"]
    return (f"prefill: first run {p1['eager_calls']} eager, "
            f"{p1['captures']} captures; second run "
            f"{p2['captures'] - p1['captures']} captures "
            f"({p2['capture_s'] - p1['capture_s']:.3f} s of host time), "
            f"{p2['replays'] - p1['replays']} replays")


def first_run_tokens_per_s(torch, cfg, flags, params, prompts, ecfg,
                           staged) -> float:
    """Tokens/s of ``prompts`` served by a fresh engine, eager or staged
    (phase 3s's repeated first runs)."""
    eng, system = make_engine(cfg, flags, params, ecfg, "cuda", staged)
    rids, _, wall = drain(eng, prompts)
    torch.cuda.synchronize()
    tokens = sum(len(eng.requests[r].out_tokens) for r in rids)
    system.close()
    return tokens / wall


def replay_trace(torch, eng, cfg, flags, params) -> dict:
    """One replay of a staged engine's graph, traced with
    ``torch.profiler``: its device operations in order (the graph is one
    stream's capture, so they run in the step's order).  The paged step's
    graph at its largest batch size B must hold exactly one
    ``paged_split_kernel`` and one ``paged_combine_kernel`` a layer: a
    replay calls no wrapper, so this is what the replayed launch counts
    rest on.  On the dense slot path the graph of the slot that stepped
    most (B = 1) is traced, which holds no kernel of the port (its
    decode step is PyTorch's operations alone).  For an MoE model the
    MoE layer is found in the same trace: ``moe_apply`` run eagerly at
    the step's input shape [B, 1, D] is traced on its own, and its
    sequence of operation names must occur once a layer in the replay's;
    the matched operations' device time over the replay's is the MoE
    share, and its GEMM kernels' (``GEMM_KERNELS``: the expert products
    and the router) the expert share."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.configs.base import MOE
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.transformer import layer

    def device_ops(fn, attempts=3):
        # the first call is the profiler's warm-up, discarded: a trace's
        # first operations can be lost while the tracer starts.  A trace
        # can also come back with no device operation at all (seen once in
        # a few dozen); it is taken again, since an empty sequence would
        # match everywhere in the MoE search below
        for _ in range(attempts):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1)) as prof:
                for _ in range(2):
                    fn()
                    torch.cuda.synchronize()
                    prof.step()
            # the step's own span ("ProfilerStep#1") is not an operation
            evs = sorted((e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and not e.name.startswith("ProfilerStep")),
                         key=lambda e: e.time_range.start)
            if evs:
                # a fill's or copy's memory kind: "Memset (Device)" when
                # run eagerly, "Memset (Unknown)" as a graph node
                return [(e.name.split(" (")[0]
                         if e.name.startswith(("Memset", "Memcpy"))
                         else e.name, e.time_range.elapsed_us())
                        for e in evs]
        raise AssertionError(f"{attempts} traces recorded no device "
                             "operation")

    if eng._use_paged:
        # graphs by (pool address, pool rows, B): the largest B's
        key = max(eng.staged.graphs, key=lambda k: k[2])
        B, graph = key[2], eng.staged.graphs[key].graph
    else:
        # graphs by slot: the most stepped captured slot's
        calls = eng.staged.calls
        B, graph = 1, eng.staged.graphs[max(eng.staged.graphs,
                                            key=calls.get)].graph
    ops_ = device_ops(graph.replay)    # not counted: no wrapper runs
    names = [n for n, _ in ops_]
    busy = sum(us for _, us in ops_)
    L = cfg.num_layers
    split = sum("paged_split_kernel" in n for n in names)
    combine = sum("paged_combine_kernel" in n for n in names)
    out = {"B": B, "ops": len(ops_), "device_ms": busy / 1e3,
           "paged_split": split, "paged_combine": combine}
    if eng._use_paged and (split, combine) != (L, L):
        raise AssertionError(f"{cfg.name}: the replay ran {split} split and "
                             f"{combine} combine kernels, not {L} each; "
                             f"{len(ops_)} operations, first {names[:8]}")
    if cfg.block_type == MOE:
        lp = layer(params["trunk"], 0)["moe"]
        x = torch.randn((B, 1, cfg.d_model), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0)
                        ).to(dtype_of(cfg))
        with torch.no_grad():
            seq = [n for n, _ in device_ops(
                lambda: moe_mod.moe_apply(lp, cfg, x, flags))]
        m, at, moe_us, gemm_us = len(seq), 0, 0.0, 0.0
        hits = 0
        while at + m <= len(names):
            if names[at:at + m] == seq:
                for n, us in ops_[at:at + m]:
                    moe_us += us
                    if any(k in n.lower() for k in GEMM_KERNELS):
                        gemm_us += us
                hits += 1
                at += m
            else:
                at += 1
        if hits != L:
            raise AssertionError(f"{cfg.name}: moe_apply's {m} operations "
                                 f"occur {hits} times in the replay, not "
                                 f"{L}; moe_apply: {seq}")
        out.update(moe_ops_per_layer=m, moe_ms=moe_us / 1e3,
                   moe_share=moe_us / busy, expert_gemm_share=gemm_us / busy)
    return out


def ms(xs) -> str:
    """Median and mean of per-step milliseconds."""
    return (f"median {_pct(xs, 50):.3f} ms, mean {sum(xs) / len(xs):.3f} ms "
            f"over {len(xs)}")


def moe_text(tr) -> str:
    """A traced replay's MoE share, for an MoE model (else nothing)."""
    if "moe_ms" not in tr:
        return ""
    return (f"; MoE {tr['moe_ms']:.3f} ms, {tr['moe_ops_per_layer']} "
            f"operations a layer, share {tr['moe_share']:.3f}, expert GEMMs' "
            f"share {tr['expert_gemm_share']:.3f}")


def eager_and_staged(torch, cfg, flags, prompts, ecfg, pairs) -> tuple:
    """Phases 3s's and 3d's runs of ``cfg`` (params from seed 0): a
    warm-up, then one eager (``staged=False``) and one staged engine
    (:func:`staged_run`), then ``pairs - 1`` more pairs of fresh engines'
    first runs, the order alternating (a first run's tokens/s moves a few
    per cent between runs).  Fails unless the first runs' streams, link
    bytes, onboard hits and misses, launch and dispatch counts, paged
    rounds and decode steps are equal, and the second runs' streams.
    Returns (eager, staged, first-run tokens/s by ``staged``)."""
    from repro_torch.models import build_model

    left = free_card(torch)
    if left > 1.0:
        raise AssertionError(f"{left:.2f} GiB of earlier phases still on "
                             "the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = build_model(cfg, flags, device="cuda").init(gen)
    # warm-up: cuBLAS handles, the allocator, the kernels
    staged_run(torch, cfg, flags, params, [(prompts[0][0][:16], 2)], ecfg,
               False)
    eager, staged = (staged_run(torch, cfg, flags, params, prompts, ecfg, s)
                     for s in (False, True))
    fresh = {False: [eager["first"]["tokens_per_s"]],
             True: [staged["first"]["tokens_per_s"]]}
    for k in range(1, pairs):
        for s in ((False, True) if k % 2 == 0 else (True, False)):
            fresh[s].append(first_run_tokens_per_s(
                torch, cfg, flags, params, prompts, ecfg, s))
    del params
    e1, s1 = eager["first"], staged["first"]
    for key in ("streams", "link_bytes", "hits", "misses", "launches",
                "dispatches", "paged_rounds", "decode_steps"):
        if e1[key] != s1[key]:
            raise AssertionError(f"{cfg.name}: staged {key} {s1[key]} != "
                                 f"eager {e1[key]}")
    if eager["second"]["streams"] != staged["second"]["streams"]:
        raise AssertionError(f"{cfg.name}: second runs' streams differ")
    # prefill: each prompt length's first prefill eager; in the second
    # run the first length captured, each other as the rule says
    lengths = len({len(p) for p, _ in prompts})
    p1, p2 = s1["staged_prefill"], staged["second"]["staged_prefill"]
    if p1["eager_calls"] != lengths or p1["captures"] or \
            not 1 <= p2["captures"] <= lengths or \
            p2["eager_calls"] != lengths + p2["eager_repeats"] or \
            p2["eager_calls"] + p2["replays"] != 2 * len(prompts):
        raise AssertionError(f"{cfg.name}: staged prefill {p1} then {p2}")
    return eager, staged, fresh


def staged_phase(torch, lens, news, card) -> dict:
    """Phase 3s: qwen2-1.5b (full) and dbrx-132b (full width, 8 of 40
    layers) served eager (``staged=False``) and staged, one engine each,
    the same params and prompts (:func:`staged_run`).  Fails unless the
    greedy streams, link bytes, onboard hits and misses and launch and
    dispatch counts are equal, the paged kernel launched layers x rounds,
    the staged engine ran each batch size's first round eagerly and
    every later one from a graph, and one replay's trace holds the paged
    kernels once a layer.  Prints captures and replays, the model step
    per round and tokens/s, staged beside eager (the first runs of
    ``FRESH_PAIRS`` fresh engines each), the replay's device time (and
    for dbrx-132b its MoE share), on the card."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.flags import Flags
    from repro_torch.serve import EngineConfig

    ecfg = EngineConfig(decode_slots=8, page_tokens=32, max_seq_len=512,
                        onboard_pages=16)
    flags = Flags(remat=False, use_kernels=True)
    dbrx = dataclasses.replace(get_config("dbrx-132b"),
                               num_layers=DBRX_LAYERS)
    out = {}
    for seed, cfg in ((10, get_config("qwen2-1.5b")), (11, dbrx)):
        t0 = time.monotonic()
        eager, staged, fresh = eager_and_staged(
            torch, cfg, flags, prompts_for(cfg, lens, news, seed), ecfg,
            FRESH_PAIRS)
        L = cfg.num_layers
        s1 = staged["first"]
        if s1["launches"].get("paged_attention") != L * s1["paged_rounds"]:
            raise AssertionError(f"{cfg.name}: paged ran "
                                 f"{s1['launches']} times, not {L} x "
                                 f"{s1['paged_rounds']}")
        st1, st2 = s1["staged"], staged["second"]["staged"]
        if st1["eager_calls"] != len(st1["calls"]) + \
                st1["eager_repeats"] or \
                st1["eager_calls"] + st1["replays"] != \
                s1["paged_rounds"] or st1["captures"] < 1 or \
                st2["eager_calls"] + st2["replays"] - st1["eager_calls"] - \
                st1["replays"] != staged["second"]["paged_rounds"]:
            raise AssertionError(f"{cfg.name}: captures and replays {st1} "
                                 f"then {st2}")
        tr = staged["trace"]
        med = {s: _pct(xs, 50) for s, xs in fresh.items()}
        first_ratio = med[True] / med[False]
        ahead = sum(a > b for a, b in zip(fresh[True], fresh[False]))
        print(f"phase 3s: {cfg.name}, {L} layers, eager and staged: equal "
              f"streams, link bytes {s1['link_bytes']}, hits {s1['hits']}, "
              f"misses {s1['misses']}, launches {s1['launches']}; batch "
              f"sizes {st1['calls']}: first run {st1['eager_calls']} "
              f"eager rounds ({st1['eager_repeats']} of a batch size met "
              f"before), {st1['captures']} "
              f"captures ({st1['capture_s']:.3f} s of host time), "
              f"{st1['replays']} replays; second run "
              f"{st2['captures'] - st1['captures']} captures, "
              f"{st2['replays'] - st1['replays']} replays; pool buffer "
              f"{st2['pool_pages']} pages after {st2['regrowths']} "
              f"regrowths; {prefill_text(staged)}")
        print(f"  first run tokens/s, {FRESH_PAIRS} fresh engines each, "
              f"the order alternating: eager "
              f"{[round(x, 1) for x in fresh[False]]}, staged "
              f"{[round(x, 1) for x in fresh[True]]} (captures included); "
              f"medians staged/eager {first_ratio:.3f}, staged ahead in "
              f"{ahead} of {FRESH_PAIRS} pairs; second run: eager "
              f"{eager['second']['tokens_per_s']:.1f}, staged "
              f"{staged['second']['tokens_per_s']:.1f}")
        print(f"  model step per round (second run, synchronised): eager "
              f"{ms(eager['second']['step_ms'])}; staged replays "
              f"{ms(staged['second']['step_ms'])}, capture rounds "
              f"{[round(x, 3) for x in staged['second']['capture_ms']]} ms"
              f", eager rounds "
              f"{[round(x, 3) for x in staged['second']['eager_ms']]} ms")
        print(f"  replay at B={tr['B']} traced: {tr['ops']} device "
              f"operations, {tr['paged_split']} paged_split_kernel and "
              f"{tr['paged_combine']} paged_combine_kernel, device time "
              f"{tr['device_ms']:.3f} ms{moe_text(tr)}; on {card}; "
              f"{time.monotonic() - t0:.1f} s")
        out[cfg.name] = {"eager": eager, "staged": staged}
    free_card(torch)
    return out


def staged_dense_phase(torch, lens, news, card, archs=DENSE_STAGED_RUN
                       ) -> dict:
    """Phase 3d: the dense slot path (each request alone at B = 1 against
    its own cache, as the reference's ``jax.jit(model.decode_step)``)
    served eager (``staged=False``) and staged, one engine each, the same
    params and prompts (:func:`staged_run`), for ``archs`` (by default
    rwkv6-7b and h2o-danube-3-4b at full width and depth, phase 3's
    prompt lengths).  Fails unless the greedy streams, link bytes, onboard
    hits and misses and launch and dispatch counts are equal, the prefill
    kernel (``rwkv6_scan`` or ``flash_attention``) launched layers x
    prompts and the paged kernel never, each slot's first step ran
    eagerly, its second captured and every later one replayed, and the
    second run captured nothing.  Prints the model step per decode step,
    eager beside replayed (synchronised medians), first-run tokens/s of
    ``DENSE_FRESH_PAIRS`` fresh engines each, staged beside eager, and
    one replay's device time and operation count, on the card."""
    from repro_torch.configs.base import RWKV6, get_config
    from repro_torch.models.flags import Flags
    from repro_torch.serve import EngineConfig

    ecfg = EngineConfig(decode_slots=8, page_tokens=32, max_seq_len=512,
                        onboard_pages=16)
    flags = Flags(remat=False, use_kernels=True)
    out = {}
    for arch in archs:
        layers, seed = DENSE_STAGED[arch]
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        t0 = time.monotonic()
        prompts = prompts_for(cfg, lens, news, seed)
        eager, staged, fresh = eager_and_staged(
            torch, cfg, flags, prompts, ecfg, DENSE_FRESH_PAIRS)
        L = cfg.num_layers
        s1 = staged["first"]
        kernel = "rwkv6_scan" if cfg.block_type == RWKV6 \
            else "flash_attention"
        got = s1["launches"]
        if got.get(kernel) != L * len(prompts) or s1["paged_rounds"] or \
                got.get("paged_attention", 0):
            raise AssertionError(f"{cfg.name}: launches {got}, "
                                 f"{s1['paged_rounds']} paged rounds; want "
                                 f"{kernel} {L} x {len(prompts)}, no paged")
        st1, st2 = s1["staged"], staged["second"]["staged"]
        steps = list(st1["calls"].values())
        if st1["eager_calls"] != len(steps) + st1["eager_repeats"] or \
                not 1 <= st1["captures"] <= sum(n > 1 for n in steps) or \
                sum(steps) != s1["decode_steps"] or \
                st1["replays"] != sum(steps) - st1["eager_calls"] or \
                st2["eager_calls"] + st2["replays"] - st1["eager_calls"] - \
                st1["replays"] != staged["second"]["decode_steps"]:
            raise AssertionError(f"{cfg.name}: eager steps, captures and "
                                 f"replays {st1} then {st2}")
        tr = staged["trace"]
        med = {s: _pct(xs, 50) for s, xs in fresh.items()}
        step_med = {s: _pct(r["second"]["step_ms"], 50)
                    for s, r in ((False, eager), (True, staged))}
        print(f"phase 3d: {cfg.name}, {L} layers, dense slot path, eager "
              f"and staged: equal streams, link bytes {s1['link_bytes']}, "
              f"hits {s1['hits']}, misses {s1['misses']}, launches {got}; "
              f"{st1['slots']} slots, steps a slot {steps}: first run "
              f"{st1['eager_calls']} eager steps ({st1['eager_repeats']} "
              f"of a slot stepped before), {st1['captures']} "
              f"captures ({st1['capture_s']:.3f} s of host time), "
              f"{st1['replays']} replays; second run "
              f"{st2['captures'] - st1['captures']} captures, "
              f"{st2['replays'] - st1['replays']} replays; "
              f"{prefill_text(staged)}")
        print(f"  model step per decode step (second run, synchronised): "
              f"eager {ms(eager['second']['step_ms'])}; staged replays "
              f"{ms(staged['second']['step_ms'])}; medians staged/eager "
              f"{step_med[True] / step_med[False]:.3f}")
        print(f"  first run tokens/s, {DENSE_FRESH_PAIRS} fresh engines "
              f"each, the order alternating: eager "
              f"{[round(x, 1) for x in fresh[False]]}, staged "
              f"{[round(x, 1) for x in fresh[True]]} (captures included); "
              f"medians staged/eager {med[True] / med[False]:.3f}; second "
              f"run: eager {eager['second']['tokens_per_s']:.1f}, staged "
              f"{staged['second']['tokens_per_s']:.1f}")
        print(f"  one slot's replay traced: {tr['ops']} device operations, "
              f"device time {tr['device_ms']:.3f} ms{moe_text(tr)}; on "
              f"{card}; {time.monotonic() - t0:.1f} s")
        out[cfg.name] = {"eager": eager, "staged": staged}
    free_card(torch)
    return out


def prefill_run(torch, cfg, flags, params, prompts, ecfg, staged) -> dict:
    """Phase 3p's work on one engine, eager (``staged=False``) or staged:
    ``prompts`` served ``PREFILL_PASSES`` times, with each prefill timed on
    the host, the device synchronised around it.  The counts are reset
    just before the first pass and read after the last, and the peak
    device memory is the engine's (the params included)."""
    from repro_torch.core.metrics import GLOBAL_METRICS
    from repro_torch.kernels import cuda_build, ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng, system = make_engine(cfg, flags, params, ecfg, "cuda", staged)
    fn, prefill_ms = eng._prefill_fn, []

    def timed(*args):
        torch.cuda.synchronize()
        t = time.monotonic()
        out = fn(*args)
        torch.cuda.synchronize()
        prefill_ms.append((time.monotonic() - t) * 1e3)
        return out

    eng._prefill_fn = timed
    GLOBAL_METRICS.reset()             # the onboard tier's hits and misses
    cuda_build.reset_launch_counts()
    calls = ops.dispatch_counts()
    passes = []
    for _ in range(PREFILL_PASSES):
        n0 = len(prefill_ms)
        rids, _, wall = drain(eng, prompts)
        torch.cuda.synchronize()
        reqs = [eng.requests[r] for r in rids]
        if not all(r.state == "done" for r in reqs):
            raise AssertionError(f"not all done: {[r.state for r in reqs]}")
        streams = [list(r.out_tokens) for r in reqs]
        passes.append({
            "streams": streams, "wall_s": wall,
            "tokens_per_s": sum(len(x) for x in streams) / wall,
            "mean_ttft_s": sum(r.first_token_at - r.submitted_at
                               for r in reqs) / len(reqs),
            "prefill_ms": prefill_ms[n0:],
            "staged_prefill": prefill_stats(eng)})
    tier = eng.kv.buf.metrics.tier(eng.kv.buf.name, "onboard")
    out = {"passes": passes, "launches": cuda_build.launch_counts(),
           "dispatches": {k: v - calls[k]
                          for k, v in ops.dispatch_counts().items()},
           "link_bytes": dict(eng.kv.buf.host.fm.op_bytes()),
           "hits": tier.hits, "misses": tier.misses,
           "paged_rounds": eng.paged_rounds,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "pool_bytes": (eng.staged_prefill.pool_bytes()
                          if eng.staged_prefill else 0)}
    system.close()
    del eng
    return out


def staged_prefill_phase(torch, lens, card) -> dict:
    """Phase 3p: prefill staged as the reference's
    ``jax.jit(model.prefill)`` (one CUDA graph per prompt length), on
    ``PREFILL_STAGED``'s full-width configs in bf16 with phase 3's engine:
    phase 3's 8 prompt lengths, ``PREFILL_NEW_TOKENS`` new tokens each,
    served ``PREFILL_PASSES`` times through one engine, once staged and
    once eager (:func:`prefill_run`).  Fails unless every pass's streams,
    and the link bytes, onboard hits and misses, launch and dispatch
    counts of the three passes, are equal staged and eager, the prefill
    kernel launched layers x prompts x passes in both, and the staged
    engine prefilled pass 1 eagerly and captured the first length at its
    second prefill (pass 2), every other length as the capture rule
    says.  Prints the median prefill a prompt,
    synchronised (the eager engine's, and the staged engine's pass by
    pass), the captures, replays and their host time, the prefill graphs'
    pool bytes, pass 3's mean TTFT and tokens/s staged beside eager, and
    each engine's peak device memory, on the card."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model
    from repro_torch.models.flags import Flags
    from repro_torch.serve import EngineConfig

    ecfg = EngineConfig(decode_slots=8, page_tokens=32, max_seq_len=512,
                        onboard_pages=16)
    flags = Flags(remat=False, use_kernels=True)
    out = {}
    for arch, seed, kernel in PREFILL_STAGED:
        t0 = time.monotonic()
        cfg = get_config(arch)
        prompts = prompts_for(cfg, lens, [PREFILL_NEW_TOKENS] * len(lens),
                              seed)
        left = free_card(torch)
        if left > 1.0:
            raise AssertionError(f"{left:.2f} GiB of earlier phases still "
                                 "on the card")
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = build_model(cfg, flags, device="cuda").init(gen)
        # warm-up: cuBLAS handles, the allocator, the kernels
        prefill_run(torch, cfg, flags, params, [(prompts[0][0][:16], 2)],
                    ecfg, False)
        eager, staged = (prefill_run(torch, cfg, flags, params, prompts,
                                     ecfg, s) for s in (False, True))
        del params
        for key in ("launches", "dispatches", "link_bytes", "hits",
                    "misses", "paged_rounds"):
            if eager[key] != staged[key]:
                raise AssertionError(f"{arch}: staged {key} {staged[key]} "
                                     f"!= eager {eager[key]}")
        for k, (e, s) in enumerate(zip(eager["passes"], staged["passes"])):
            if e["streams"] != s["streams"]:
                raise AssertionError(f"{arch}: pass {k + 1}'s streams differ")
        L, n = cfg.num_layers, len(prompts)
        want = L * n * PREFILL_PASSES
        if staged["launches"].get(kernel) != want:
            raise AssertionError(f"{arch}: {kernel} ran "
                                 f"{staged['launches'].get(kernel)} times, "
                                 f"not {L} x {n} x {PREFILL_PASSES}")
        sp = [p["staged_prefill"] for p in staged["passes"]]
        if (sp[0]["eager_calls"], sp[0]["captures"], sp[0]["replays"]) \
                != (n, 0, 0) or sp[1]["captures"] < 1 or \
                any(p["eager_calls"] != n + p["eager_repeats"] or
                    p["eager_calls"] + p["replays"] != n * (k + 1)
                    for k, p in enumerate(sp)):
            raise AssertionError(f"{arch}: eager prefills, captures and "
                                 f"replays by pass: {sp}")
        med = [_pct(p["prefill_ms"], 50) for p in staged["passes"]]
        e3, s3 = eager["passes"][-1], staged["passes"][-1]
        print(f"phase 3p: {arch}, {L} layers, staged prefill, {n} prompt "
              f"lengths x {PREFILL_PASSES} passes: equal streams, link "
              f"bytes {staged['link_bytes']}, hits {staged['hits']}, misses "
              f"{staged['misses']}, launches {staged['launches']}; pass 1 "
              f"{sp[0]['eager_calls']} eager, pass 2 "
              f"{sp[1]['captures']} captures, pass 3 "
              f"{sp[2]['captures'] - sp[1]['captures']} captures "
              f"({sp[2]['capture_s']:.3f} s of host time in all), "
              f"{sp[2]['replays'] - sp[1]['replays']} replays and "
              f"{sp[2]['eager_calls'] - sp[1]['eager_calls']} eager; "
              f"prefill graphs' pool {staged['pool_bytes']:,} B")
        print(f"  prefill a prompt (median, synchronised): eager engine "
              f"{_pct(e3['prefill_ms'], 50):.3f} ms (pass 3); staged pass 1 "
              f"eager {med[0]:.3f}, pass 2 {med[1]:.3f}, pass 3 "
              f"{med[2]:.3f} ms; pass 3 staged/eager "
              f"{med[2] / _pct(e3['prefill_ms'], 50):.3f}")
        print(f"  pass 3: mean TTFT eager {e3['mean_ttft_s'] * 1e3:.2f} ms, "
              f"staged {s3['mean_ttft_s'] * 1e3:.2f} ms; tokens/s eager "
              f"{e3['tokens_per_s']:.1f}, staged {s3['tokens_per_s']:.1f}; "
              f"peak eager {eager['peak_gib']:.3f} GiB, staged "
              f"{staged['peak_gib']:.3f} GiB; on {card}; "
              f"{time.monotonic() - t0:.1f} s")
        out[arch] = {"eager": eager, "staged": staged}
    free_card(torch)
    return out


def quickstart_phase(torch) -> None:
    """Phase 3q: ``examples/quickstart_torch.py`` run in this process on
    the card (its L2P buffer's 8 onboard pages on the card, its LMB tier
    in pinned host memory) and on the CPU.  Fails unless the card's run
    used both tiers and printed the CPU run's L2P statistics and fabric
    snapshot (hits, link bytes and the modelled link wait)."""
    import contextlib
    import io
    import runpy
    from repro_torch.core.metrics import GLOBAL_METRICS

    path = ROOT / "examples" / "quickstart_torch.py"
    t0 = time.monotonic()
    lines = {}
    for device in ("cuda", "cpu"):
        GLOBAL_METRICS.reset()          # the buffer's hit ratio reads it
        text, argv = io.StringIO(), sys.argv
        sys.argv = [str(path), "--device", device]
        try:
            with contextlib.redirect_stdout(text):
                flow = runpy.run_path(str(path), run_name="__main__")
        finally:
            sys.argv = argv
        ex = flow["l2p"].executor
        if ex.device.type != device or ex.real_host_tier != (
                device == "cuda"):
            raise AssertionError(f"the quickstart on {device} ran on "
                                 f"{ex.device}, pinned host tier "
                                 f"{ex.real_host_tier}")
        lines[device] = [x for x in text.getvalue().splitlines()
                         if x.startswith(("l2p stats:", "fm snapshot:"))]
    if len(lines["cuda"]) != 2 or lines["cuda"] != lines["cpu"]:
        raise AssertionError(f"quickstart: card {lines['cuda']} != CPU "
                             f"{lines['cpu']}")
    print(f"phase 3q: examples/quickstart_torch.py on the card (onboard "
          f"pages on the card, the LMB tier in pinned host memory) and on "
          f"the CPU: equal L2P stats and fabric snapshot; "
          f"{lines['cuda'][0][:160]}...; {time.monotonic() - t0:.1f} s")


#: phase 3t: the LMB tier's page geometries (qwen2-1.5b's KV page of
#: 917,504 B and chameleon-34b's of 6,291,456 B, bf16) and each run's
#: seeded operations
STRESS_PAGES = (("qwen2-1.5b", (28, 2, 32, 2, 128), 300),
                ("chameleon-34b", (48, 2, 32, 8, 128), 200))


def stress_run(torch, device, shape, n_ops, seed=0) -> dict:
    """A ``LinkedBuffer`` of 16 pages over 4 onboard on ``device``,
    driven through ``n_ops`` seeded operations: scalar and batched reads
    and writes (batches past the onboard tier wave) and the evictions
    they force, pages freed and held again, and prefetch bursts into the
    slots that frees.  Every read leaves a fingerprint (its bits
    summed with position weights, on the device); returns them, every
    page and the buffer's counters, the card synchronised first."""
    import numpy as np
    from repro_torch.core import TierExecutor, system_for
    from repro_torch.core.buffer import LinkedBuffer
    from repro_torch.core.metrics import Metrics

    n = 16
    buf = LinkedBuffer(
        name="stress", device_id="dev0",
        host=system_for("dev0", pool_gib=2, page_bytes=4096).host(),
        executor=TierExecutor(device), page_shape=shape,
        dtype=torch.bfloat16, onboard_pages=4, policy="cost",
        prefetch_depth=2, metrics=Metrics())
    buf.append_pages(n)
    gen = torch.Generator().manual_seed(seed)
    data = torch.randn((24, *shape), generator=gen).to(torch.bfloat16)
    numel = data[0].numel()
    weight = torch.arange(1, numel + 1, device=device, dtype=torch.int64) % \
        65521

    def mark(x):
        bits = x.reshape(x.shape[0], -1).view(torch.int16).to(torch.int64)
        return (bits * weight).sum(dim=1)
    rng = np.random.default_rng(seed)
    marks = []
    for _ in range(n_ops):
        kind = rng.integers(0, 6)
        if kind == 0:
            buf.write(int(rng.integers(0, n)),
                      data[int(rng.integers(0, len(data)))].to(device))
        elif kind == 5:
            # the page's storage freed and the page held again (zeros):
            # an onboard slot a prefetch burst can fill
            p = int(rng.integers(0, n))
            buf.release(p)
            buf.share(p)
        elif kind == 1:
            marks.append(mark(buf.read(int(rng.integers(0, n)))[None]))
        elif kind == 2:
            pages = [int(x) for x in rng.integers(0, n, 6)]
            which = [int(x) for x in rng.integers(0, len(data), 6)]
            buf.write_many(pages, data[which].to(device))
        elif kind == 3:
            pages = [int(x) for x in rng.integers(0, n, 7)]
            marks.append(mark(buf.read_many(pages)))
        else:
            buf.schedule_prefetch([int(x) for x in rng.integers(0, n, 3)])
    if device != "cpu":
        torch.cuda.synchronize()
    lmb = {p: buf._lmb_pools[e.slot // buf._lmb_chunk_pages][
               e.slot % buf._lmb_chunk_pages].clone()
           for p, e in enumerate(buf._pages) if e.tier == "lmb"}
    pages = buf.read_many(list(range(n))).cpu()
    c = buf.metrics.tier("stress", "onboard")
    out = {"marks": torch.cat(marks).cpu(), "pages": pages, "lmb": lmb,
           "hits": c.hits, "misses": c.misses,
           "op_bytes": buf.host.fm.op_bytes(),
           "tiers": [buf.tier_of(p) for p in range(n)],
           "prefetch": buf.prefetch_stats(), "link_wait_s": buf.link_wait_s,
           "pinned": buf.executor.real_host_tier}
    buf.check_invariants()
    return out


def tier_stress_phase(torch) -> None:
    """Phase 3t: ``stress_run`` on the card (the LMB tier in pinned host
    memory, every burst on the copy streams, nothing waited for on the
    host) and on the CPU (modelling mode), at both page sizes: every
    read's fingerprint, every page, the LMB pools' bytes of every
    LMB-resident page after a sync, hits, misses, link bytes, residency,
    prefetch counters and the modelled link wait must be equal."""
    for name, shape, n_ops in STRESS_PAGES:
        t0 = time.monotonic()
        card = stress_run(torch, "cuda", shape, n_ops)
        t_card = time.monotonic() - t0
        cpu = stress_run(torch, "cpu", shape, n_ops)
        nbytes = card["pages"][0].numel() * 2
        if not card["pinned"] or cpu["pinned"]:
            raise AssertionError("phase 3t: the card's run did not page "
                                 "through pinned host memory")
        if not torch.equal(card["marks"], cpu["marks"]):
            bad = int((card["marks"] != cpu["marks"]).sum())
            raise AssertionError(f"phase 3t {name}: {bad} of "
                                 f"{len(cpu['marks'])} pages read on the "
                                 "card differ from the CPU's")
        if not torch.equal(card["pages"], cpu["pages"]) or \
                card["lmb"].keys() != cpu["lmb"].keys() or \
                not all(torch.equal(card["lmb"][p], cpu["lmb"][p])
                        for p in cpu["lmb"]):
            raise AssertionError(f"phase 3t {name}: pages differ")
        for key in ("hits", "misses", "op_bytes", "tiers", "prefetch",
                    "link_wait_s"):
            if card[key] != cpu[key]:
                raise AssertionError(f"phase 3t {name}: {key} "
                                     f"{card[key]} != {cpu[key]}")
        print(f"phase 3t: {name} pages of {nbytes:,} B, 16 over 4 onboard, "
              f"{n_ops} seeded operations on the card (LMB tier pinned, "
              f"bursts on the copy streams) and on the CPU: {len(cpu['marks'])}"
              f" reads, every page, {len(cpu['lmb'])} LMB-resident pages' "
              f"pool bytes, hits {cpu['hits']}, misses {cpu['misses']}, link "
              f"bytes {cpu['op_bytes']} and prefetch "
              f"{cpu['prefetch']['pages']} pages equal; card run "
              f"{t_card:.2f} s")


def reduced_wave_phase(torch) -> None:
    """Phase 3w: reduced qwen2-1.5b in f32, 4 decode slots over 4 onboard
    pages (every round's view waves and evicts), on the card (kernels,
    the LMB tier pinned and paged on the copy streams) and on the CPU
    (plain versions, modelling mode), the same params and prompts: token
    streams, link bytes per class, hits, misses and every pool's rows
    after a sync must agree (pools within 1e-4: the two devices compute
    the KV in different orders)."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.core.metrics import GLOBAL_METRICS
    from repro_torch.models import build_model
    from repro_torch.models.flags import Flags
    from repro_torch.serve import EngineConfig

    cfg = get_config("qwen2-1.5b").reduced()
    flags = Flags(remat=False, use_kernels=True)
    cpu_params = build_model(cfg, flags, device="cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(8)
    specs = [(rng.integers(0, 100, 20).astype(np.int32), 6)
             for _ in range(6)]
    ecfg = EngineConfig(decode_slots=4, max_seq_len=64, page_tokens=8,
                        onboard_pages=4, round_time_s=1e-3)
    runs = []
    for device in ("cpu", "cuda"):
        GLOBAL_METRICS.reset()
        params = cpu_params if device == "cpu" else _to(cpu_params, device)
        eng, rids, _, _, system = serve(torch, cfg, flags, params, specs,
                                        ecfg, device)
        if device == "cuda":
            torch.cuda.synchronize()
        buf = eng.kv.buf
        c = buf.metrics.tier(buf.name, "onboard")
        runs.append({
            "streams": [eng.requests[r].out_tokens for r in rids],
            "op_bytes": buf.host.fm.op_bytes(), "hits": c.hits,
            "misses": c.misses, "stats": buf.stats(),
            "pools": [None if p is None else p.cpu().clone()
                      for p in buf._lmb_pools] + [buf._onboard_pool.cpu()],
            "pinned": buf.executor.real_host_tier})
        system.close()
    cpu, card = runs
    if not card["pinned"] or card["misses"] <= 0:
        raise AssertionError("phase 3w: the card's KV did not wave through "
                             "a pinned LMB tier")
    for key in ("streams", "op_bytes", "hits", "misses"):
        if card[key] != cpu[key]:
            raise AssertionError(f"phase 3w: {key} {card[key]} != "
                                 f"{cpu[key]}")
    for key in ("resident", "link_wait_s", "prefetch", "lmb_placement"):
        if card["stats"][key] != cpu["stats"][key]:
            raise AssertionError(f"phase 3w: {key} {card['stats'][key]} "
                                 f"!= {cpu['stats'][key]}")
    err = max(check(f"pool {i}", a, b, 1e-4)
              for i, (a, b) in enumerate(zip(card["pools"], cpu["pools"]))
              if a is not None)
    print(f"phase 3w: reduced qwen2-1.5b f32, 6 requests through 4 slots "
          f"over 4 onboard pages, card (pinned LMB tier, copy streams) "
          f"against CPU: streams identical "
          f"({sum(map(len, cpu['streams']))} tokens), link bytes "
          f"{cpu['op_bytes']}, hits {cpu['hits']}, misses {cpu['misses']}, "
          f"residency and modelled waits equal; {len(cpu['pools'])} pools "
          f"within {err:.2e}")


def sync_refusal_phase(torch) -> None:
    """Phase 9, last (a failed capture leaves the stream it captured on
    in no state to trust): a host sync injected into each staged
    function runs in its eager first call and must make the engine raise
    at the second call's capture, with no graph made and no eager call
    run in its place: prefill (reduced qwen2-1.5b, two requests of one
    prompt length), the dense slot step (reduced h2o-danube-3-4b, one
    request in its one slot), the train step (reduced qwen2-1.5b through
    the launcher, the sync in its first two steps) and the paged step
    (reduced qwen2-1.5b, one request, so B = 1 every round)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import system_for
    from repro_torch.models import build_model
    from repro_torch.models.flags import Flags
    from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec
    import numpy as np

    def engine(arch, requests=1):
        model = build_model(get_config(arch).reduced(),
                            Flags(remat=False, use_kernels=True),
                            device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        eng = ServeEngine(model, params,
                          system_for("gpu0", host_id="h0", pool_gib=1,
                                     page_bytes=4096),
                          EngineConfig(decode_slots=2, max_seq_len=64,
                                       page_tokens=8, onboard_pages=8),
                          device_id="gpu0", device="cuda")
        for _ in range(requests):
            eng.submit(SubmitSpec(prompt=np.arange(1, 9, dtype=np.int32),
                                  max_new_tokens=4))
        return eng

    def refused(eng, what):
        try:
            eng.run(10)
        except RuntimeError as exc:
            return str(exc).splitlines()[0][:160]
        raise AssertionError(f"a host sync inside the staged {what} did "
                             "not raise")

    # prefill first, then the dense slot step: the paged engine's failed
    # capture is the script's last use of the card.  Two requests of one
    # prompt length, both admitted in the first round: the first prefill
    # runs eagerly, the second captures
    eng = engine("qwen2-1.5b", requests=2)
    prefill = eng.staged_prefill.step

    def syncing_prefill(params, batch, cache):
        int(batch["tokens"].sum())          # a host sync
        return prefill(params, batch, cache)

    eng.staged_prefill.step = syncing_prefill
    msg = refused(eng, "prefill")
    reqs = [eng.requests[r] for r in (0, 1)]
    if eng.staged_prefill.captures or eng.staged_prefill.eager_calls != 1 \
            or [len(r.out_tokens) for r in reqs] != [1, 0]:
        raise AssertionError(f"captures {eng.staged_prefill.captures}, eager "
                             f"prefills {eng.staged_prefill.eager_calls}, "
                             f"tokens {[r.out_tokens for r in reqs]} after a "
                             "failed capture")
    print(f"phase 9: a host sync in the staged prefill ran in the length's "
          f"eager first prefill and raised at its second prefill's capture "
          f"({msg}); no graph, no eager prefill in its place")

    eng = engine("h2o-danube-3-4b")
    step = eng.staged.step

    def syncing_dense(params, cache, token):
        int(cache["step"])                  # a host sync
        return step(params, cache, token)

    eng.staged.step = syncing_dense
    msg = refused(eng, "dense slot step")
    req = eng.requests[0]
    if eng.staged.captures or eng.staged.eager_calls != 1 or \
            len(req.out_tokens) != 2:
        raise AssertionError(f"captures {eng.staged.captures}, eager steps "
                             f"{eng.staged.eager_calls}, tokens "
                             f"{req.out_tokens} after a failed capture")
    print(f"phase 9: a host sync in the staged dense slot step ran in the "
          f"slot's eager first step and raised at the second step's "
          f"capture ({msg}); no graph, no eager step in its place")

    # the train step, through the launcher (reduced qwen2-1.5b): its first
    # step runs eagerly, its second captures
    from repro_torch.launch import train
    make, calls = train.make_train_step_, []

    def syncing_train(*args, **kw):
        step_ = make(*args, **kw)

        def step(params, opt_state, batch, out, clock=None):
            calls.append(torch.cuda.is_current_stream_capturing())
            int(batch["tokens"].sum())      # a host sync
            return step_(params, opt_state, batch, out, clock)
        return step

    train.make_train_step_ = syncing_train
    try:
        train.run("qwen2-1.5b", steps=3, global_batch=4, seq_len=32,
                  verbose=False, device="cuda")
    except RuntimeError as exc:
        msg = str(exc).splitlines()[0][:160]
    else:
        raise AssertionError("a host sync inside the staged train step did "
                             "not raise")
    finally:
        train.make_train_step_ = make
    if calls != [False, True]:
        raise AssertionError(f"the train step ran {len(calls)} times "
                             f"(capturing: {calls}) around a failed capture")
    print(f"phase 9: a host sync in the staged train step ran in the eager "
          f"first step and raised at the second step's capture ({msg}); no "
          f"graph, no eager step in its place")

    eng = engine("qwen2-1.5b")
    step = eng.staged.step

    def syncing(params, pool, page_table, lengths, token):
        int(lengths.max())                  # a host sync
        return step(params, pool, page_table, lengths, token)

    eng.staged.step = syncing
    msg = refused(eng, "paged step")
    if eng.staged.captures or eng.paged_rounds != 1 or \
            eng.staged.eager_calls != 1:
        raise AssertionError(f"captures {eng.staged.captures}, paged rounds "
                             f"{eng.paged_rounds}, eager rounds "
                             f"{eng.staged.eager_calls} after a failed "
                             "capture")
    print(f"phase 9: a host sync in the staged paged step ran in the eager "
          f"first round and raised at the second round's capture ({msg}); "
          f"no graph, no eager round in its place")


def ring_check(cfg, eng, req) -> dict:
    """Phase 4e's long request on the dense slot path: its prompt passed
    the window, and its decode wrapped the ring of ``sliding_window``
    slots (every slot written, the last position past the ring).  The
    staged engine left its cache in the slot it decoded in: the one slot
    cache holding a position past its prompt, which no other request
    reaches."""
    n = len(req.prompt)
    if eng.staged is None:
        cache = req._cache
    else:
        held = [st.cache for st in eng.staged.slots.values()
                if int(st.cache["pos"].max()) >= n]
        if len(held) != 1:
            raise AssertionError(f"{len(held)} slot caches hold positions "
                                 f"past the long request's prompt")
        cache = held[0]
    C = cache["k"].shape[2]
    last = n + len(req.out_tokens) - 2      # the last token decoded
    pos = cache["pos"][0]
    step = int(cache["step"])
    got = {"prompt": n, "new_tokens": len(req.out_tokens), "ring_slots": C,
           "step": step, "last_position": int(pos.max()),
           "its_slot": last % C}
    print(f"  long request: {json.dumps(got)}")
    if C != cfg.sliding_window or n <= C or step != last + 1 or \
            got["last_position"] != last or int(pos.min()) < 0 or \
            int(pos[last % C]) != last:
        raise AssertionError(f"the long request did not wrap the ring: "
                             f"{got}")
    return got


def new_serve_phases(torch, lens, news) -> dict:
    """Phases 4e-4i: the configs the card had not served before, at full
    width (``NEW_SERVES`` gives each its depth), each with phase 3's
    engine, prompt lengths and checks, the params' bytes confirmed from
    ``abstract_params`` before init.  h2o-danube-3-4b (4e) and
    mixtral-8x22b (4i) have a window, so they decode on the dense slot
    path: flash at every prefill and no paged launch; 4e serves one more
    request of ``H2O_LONG``, whose prefill passes the window and whose
    decode wraps the ring.  granite-34b, chameleon-34b and
    command-r-plus-104b (4f-4h) decode on the LMB-paged path.
    mixtral-8x22b's MoE layer is timed apart, as dbrx's."""
    from repro_torch.configs.base import MOE, get_config
    from repro_torch.kernels.paged_attention import MMA_LAUNCHES
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import EngineConfig

    ecfg = EngineConfig(decode_slots=8, page_tokens=32, max_seq_len=512,
                        onboard_pages=16)
    served = {}
    for seed, (label, arch, layers, nbytes) in enumerate(NEW_SERVES, 5):
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        prompts = prompts_for(cfg, lens, news, seed)
        run_ecfg, inspect, ring = ecfg, None, {}
        if arch == "h2o-danube-3-4b":
            n, m = H2O_LONG
            prompts.append(prompts_for(cfg, [n], [m], seed)[0])
            run_ecfg = dataclasses.replace(ecfg, max_seq_len=n + m)

            def inspect(eng, reqs, cfg=cfg, ring=ring):
                ring.update(ring_check(cfg, eng, reqs[-1]))
        apart = (("moe", moe_mod, "moe_apply"),) \
            if cfg.block_type == MOE else ()
        served[arch] = res = serve_phase(
            torch, label, cfg, prompts, run_ecfg, apart, param_bytes=nbytes,
            inspect=inspect)
        L = cfg.num_layers
        if cfg.sliding_window is None:
            check_paged(res, cfg)
            check_counts(res, cfg, {
                "paged_attention": L * res["paged_rounds"],
                # bf16 at head_dim 128: every layer of every decode round
                # on the tensor-core split kernel
                MMA_LAUNCHES: L * res["paged_rounds"],
                "flash_attention": L * len(prompts)})
        else:
            if res["decode_path"] != "dense" or res["paged_rounds"] != 0:
                raise AssertionError(f"{arch} left the dense slot path")
            check_slots(res, cfg)
            check_counts(res, cfg, {"flash_attention": L * len(prompts),
                                    "paged_attention": 0,
                                    "paged_attention_decode": 0})
            if sum(res["lmb_link_bytes"].values()) <= 0:
                raise AssertionError(f"{arch}'s KV never crossed the LMB "
                                     "link")
        if ring:
            res["long_request"] = ring
    free_card(torch)
    return served


def exaone_serve_phase(torch, lens, news) -> dict:
    """Phase 4j: k-exaone-236b-a23b at full width, its dense layer and one
    LLLG period (``EXAONE_SERVE_LAYERS``), ``EXAONE_SERVE_HELD`` of its 128
    experts held as on one chip of the benchmark's cell, with phase 3's
    engine and prompts (16-256 tokens: rows below, at and past the
    128-token window).  It decodes on the LMB-paged path: the paged kernel
    at every layer of every round, on tensor cores, windowed at the
    windowed layers; flash at every layer of every prefill; the expert
    kernels at every expert layer of every prefill and round.  Its counts
    are the launches of the k-exaone-236b-a23b ``kernels`` rows."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import expert_ffn as ef
    from repro_torch.kernels.paged_attention import (MMA_LAUNCHES,
                                                     WINDOWED_LAUNCHES)
    from repro_torch.models.attention import layer_attention
    from repro_torch.serve import EngineConfig

    cfg = dataclasses.replace(get_config("k-exaone-236b-a23b"),
                              num_layers=EXAONE_SERVE_LAYERS,
                              experts_held=EXAONE_SERVE_HELD)
    ecfg = EngineConfig(decode_slots=8, page_tokens=32, max_seq_len=512,
                        onboard_pages=16)
    prompts = prompts_for(cfg, lens, news, 10)
    res = serve_phase(torch, "phase 4j", cfg, prompts, ecfg)
    check_paged(res, cfg)
    L, rounds = cfg.num_layers, res["paged_rounds"]
    windowed = sum(layer_attention(cfg, i)[0] is not None for i in range(L))
    check_counts(res, cfg, {
        "paged_attention": L * rounds, MMA_LAUNCHES: L * rounds,
        WINDOWED_LAUNCHES: windowed * rounds,
        "flash_attention": L * len(prompts),
        ef.LAUNCHES: (L - cfg.dense_layers) * (len(prompts) + rounds)})
    free_card(torch)
    return {"k-exaone-236b-a23b": res}


def row_launches(kernels, served) -> None:
    """Each ``kernels`` row's launches by served path, counted under its
    ``counter`` (its name where it gives none), and ``launches``, those
    of its ``path``: None where no run served that path."""
    for k in kernels:
        c = k.get("counter", k["name"])
        k["launches_by_path"] = {name: res["launches"][c]
                                 for name, res in served.items()
                                 if c in res["launches"]}
        k["launches"] = k["launches_by_path"].get(k["path"])


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
def reference_phase(torch, arch, lengths, max_seq_len, cfg=None):
    """A reduced config in f32 (``cfg``, by default ``arch``'s
    ``.reduced()``): the card (kernels) against the CPU (plain versions)
    on the same params and prompts."""
    import numpy as np
    from repro_torch.configs.base import MOE, get_config
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.flags import Flags
    from repro_torch.serve import EngineConfig

    cfg = get_config(arch).reduced() if cfg is None else cfg
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
            staged = eng.staged.stats()
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
    if path == "dense":
        # the card's dense slot steps ran from captured graphs
        check_slots({"staged": staged, "decode_path": path}, cfg)
    print(f"phase 5: reduced {arch} f32, head_dim {cfg.head_dim_}, card "
          f"against CPU plain path, {path} decode, staged on the card: "
          f"{staged['captures']} captures, {staged['replays']} replays")
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


def train_run(torch, staged: bool, **kw) -> dict:
    """One 6a run of the launcher from a card that earlier phases have
    left: its output, wall time with set-up, kernel launches and peak."""
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
                    staged=staged, **TRAIN_RUN, **kw)
    out["total_s"] = time.monotonic() - t
    out["launches"] = cuda_build.launch_counts()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def print_train_run(label: str, out: dict, card: str) -> None:
    """6a's lines for one run: set-up, then per step its mode and time
    (a serial eager step's stages apart; a traced step's device busy
    time), the bytes each way, where the state is parked and the device
    memory allocated and reserved after it."""
    from repro_torch.launch.train import TRACED
    log = out["step_log"]
    print(f"  {label}: set-up {out['total_s'] - out['wall_s']:.1f} s "
          f"(params, pinned slab, first page-out), {len(log)} steps "
          f"{out['wall_s']:.1f} s on {card}")
    for rec in log:
        tm, mv = rec["times"], rec["moved"]
        if all(k in tm for k in TRAIN_STAGES):
            how = "; ".join([
                ", ".join(f"{k} {tm[k] * 1e3:.1f}" for k in TRAIN_STAGES)
                + " ms", f"in {_gbps(mv['to_device'], tm['page_in']):.1f} "
                f"GB/s, out {_gbps(mv['to_host'], tm['page_out']):.1f} "
                "GB/s"])
        else:
            how = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in tm.items()
                            if k not in TRACED) + " ms"
            if "overlap" in tm:
                how += "; traced: " + traced_text(tm)
        print(f"    step {rec['step']} {rec['mode']}: loss "
              f"{rec['loss']:.4f}, {rec['s'] * 1e3:.1f} ms ({how}); in "
              f"{mv['to_device']:,} B, out {mv['to_host']:,} B; parked "
              f"{'/'.join(rec['parked_tiers'])}; device allocated "
              f"{rec['device_bytes'] / 2**30:.2f} GiB, reserved "
              f"{rec['device_reserved'] / 2**30:.2f} GiB")
    print(f"    peak device memory {out['peak_gib']:.2f} GiB; kernel "
          f"launches {out['launches'] or 'none'}")


def traced_text(tm: dict) -> str:
    """A traced step's device time (``train.trace.busy_split``)."""
    return (f"H2D busy {tm['h2d'] * 1e3:.1f} ms, D2H busy "
            f"{tm['d2h'] * 1e3:.1f} ms, compute busy "
            f"{tm['compute'] * 1e3:.1f} ms, copies beside compute "
            f"{tm['overlap'] * 1e3:.1f} ms, H2D beside D2H "
            f"{tm['both_ways'] * 1e3:.1f} ms, first to last operation "
            f"{tm['span'] * 1e3:.1f} ms")


def check_train_run(label: str, out: dict) -> None:
    import math
    from repro_torch.core.offload import PINNED_HOST
    state = out["state_bytes"]
    if state != QWEN_STATE_BYTES:
        raise AssertionError(f"state {state} B != {QWEN_STATE_BYTES}")
    for rec in out["step_log"]:
        if rec["moved"] != {"to_device": state, "to_host": state}:
            raise AssertionError(f"{label} step {rec['step']} moved "
                                 f"{rec['moved']}")
        if rec["parked_tiers"] != [PINNED_HOST]:
            raise AssertionError(f"{label} step {rec['step']}: state parked "
                                 f"in {rec['parked_tiers']}")
        if not rec["device_bytes"] < state:
            raise AssertionError(f"{label} step {rec['step']}: "
                                 f"{rec['device_bytes']} B on the card "
                                 "between steps")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"{label} losses {out['losses']}")
    if out["launches"]:
        raise AssertionError(f"{label} training launched kernels "
                             f"{out['launches']}")


def train_phase(torch, card: str) -> dict:
    """6a: full-width qwen2-1.5b trained through the launcher, its
    optimizer state parked in pinned host memory between steps, three
    times: staged and streamed (step 0 eager, step 1 captured, the rest
    replayed, each leaf paged on the copy streams beside the compute,
    inside the graph), staged and serial (the page moves in series with
    the step), then eager (host-stage).  Step ``TRAIN_TRACE_STEP`` of
    each staged run is traced.  Streamed must equal serial and eager bit
    for bit, losses and params (and serial's state)."""
    from repro_torch.optim.adamw import tree_leaves
    runs, kept = {}, {}
    for label, kw in TRAIN_MODES:
        out = train_run(torch, **kw)
        if not runs:
            print(f"phase 6a: qwen2-1.5b full width, bf16, {TRAIN_RUN}; "
                  f"optimizer state {out['state_bytes']:,} B (predicted "
                  f"{QWEN_STATE_BYTES:,}), LMB pool {out['pool_gib']} GiB; "
                  f"staged streamed, staged serial, then eager (the "
                  f"training path runs the plain versions, as the "
                  f"reference's)")
        print_train_run(label, out, card)
        check_train_run(label, out)
        log = out["step_log"]
        run = {"losses": out["losses"], "peak_gib": out["peak_gib"],
               "setup_s": out["total_s"] - out["wall_s"],
               "launches": out["launches"], "log": log,
               "state_bytes": out["state_bytes"],
               "allocated_gib": max(r["device_bytes"] for r in log) / 2**30,
               "reserved_gib": max(r["device_reserved"]
                                   for r in log[1:]) / 2**30}
        if kw["staged"]:
            st = out["staged"]
            print(f"    graph pool {st['pool_bytes']:,} B; "
                  f"{st['eager_calls']} eager step, {st['captures']} "
                  f"capture ({st['capture_s']:.2f} s of host), "
                  f"{st['replays']} replays (the capture's own included)")
            modes = [r["mode"] for r in log]
            want = ["eager", "capture"] + ["replay"] * (TRAIN_RUN["steps"]
                                                        - 2)
            if modes != want or out["streamed"] != kw["streamed"]:
                raise AssertionError(f"{label} modes {modes}, want {want}; "
                                     f"streamed {out['streamed']}")
            replays = [r["s"] * 1e3 for r in log if r["mode"] == "replay"
                       and r["step"] != TRAIN_TRACE_STEP]
            run.update(pool_bytes=st["pool_bytes"],
                       replay_ms=_median(replays),
                       capture_ms=log[1]["s"] * 1e3,
                       traced=log[TRAIN_TRACE_STEP]["times"])
        else:
            steady = log[1:] or log
            state = out["state_bytes"]
            run.update(
                step_ms=_median([r["s"] * 1e3 for r in steady]),
                stage_ms={k: _median([r["times"][k] * 1e3 for r in steady])
                          for k in TRAIN_STAGES},
                in_gbps=_median([_gbps(state, r["times"]["page_in"])
                                 for r in steady]),
                out_gbps=_median([_gbps(state, r["times"]["page_out"])
                                  for r in steady]))
        kept[label] = {"params": [l.cpu() for l in
                                  tree_leaves(out["params"])]}
        if label != "eager":
            # the parked state is host memory: kept to compare, the
            # streamed run's only until the serial run's is here
            kept[label]["state"] = tree_leaves(out["opt_state"])
        runs[label] = run
        del out
        if label == "serial":
            a, b = kept["streamed"].pop("state"), kept["serial"].pop("state")
            run["state_bitwise"] = all(torch.equal(x, y)
                                       for x, y in zip(a, b))
            del a, b
        free_card(torch)
    s, r, e = runs["streamed"], runs["serial"], runs["eager"]
    same = lambda x, y: all(torch.equal(a, b) for a, b in
                            zip(kept[x]["params"], kept[y]["params"]))
    bitwise = {"serial": s["losses"] == r["losses"] and same("streamed",
                                                            "serial"),
               "eager": s["losses"] == e["losses"] and same("streamed",
                                                           "eager")}
    rel = max(abs(a - b) / abs(b) for a, b in zip(s["losses"], e["losses"]))
    print(f"  streamed against serial: losses and params bitwise equal "
          f"{bitwise['serial']}, state bitwise equal {r['state_bitwise']}; "
          f"against eager: bitwise equal {bitwise['eager']} (losses max rel "
          f"err {rel:.3e})")
    for label, run in runs.items():
        if "replay_ms" in run:
            print(f"  {label}: replay {run['replay_ms']:.1f} ms (median of "
                  f"the untraced replays of steps 2-5), capture step "
                  f"{run['capture_ms']:.1f} ms, peak {run['peak_gib']:.2f} "
                  f"GiB, between steps allocated {run['allocated_gib']:.2f} "
                  f"GiB, reserved {run['reserved_gib']:.2f} GiB; traced "
                  f"step {TRAIN_TRACE_STEP}: {traced_text(run['traced'])} "
                  f"on {card}")
        else:
            print(f"  {label}: step {run['step_ms']:.1f} ms (median of steps "
                  f"1-5), peak {run['peak_gib']:.2f} GiB, between steps "
                  f"allocated {run['allocated_gib']:.2f} GiB, reserved "
                  f"{run['reserved_gib']:.2f} GiB on {card}")
    if not (bitwise["serial"] and bitwise["eager"] and r["state_bitwise"]):
        raise AssertionError(f"streamed {s['losses']}, serial "
                             f"{r['losses']}, eager {e['losses']}: "
                             f"bitwise {bitwise}, state "
                             f"{r['state_bitwise']}")
    return {"runs": runs, "losses": e["losses"],
            "state_bytes": e["state_bytes"], "launches": e["launches"]}


def _median(xs):
    return sorted(xs)[len(xs) // 2]


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

    print(f"phase 6b: reduced f32 training, staged on the card against "
          f"eager on the CPU, 5 steps (losses within {LOSS_TOL:g} "
          f"relative, params within {PARAM_TOL:g})")
    for arch in TRAIN_ARCHS:
        kw = dict(steps=5, global_batch=4, seq_len=32, grad_accum=2,
                  compress_grads=arch == "qwen2-1.5b", offload_opt=True,
                  verbose=False)
        cfg = get_config(arch).reduced()
        params = build_model(cfg, Flags(remat=False), device="cpu").init(
            torch.Generator().manual_seed(0))
        cpu = train.run(arch, device="cpu", init_params=params,
                        staged=False, **kw)
        gpu = train.run(arch, device="cuda",
                        init_params=_to(params, "cuda"), **kw)
        rel = max(abs(a - b) / abs(b) for a, b in zip(gpu["losses"],
                                                      cpu["losses"]))
        gap = _param_gap(gpu["params"], cpu["params"], 1e-3, 5)
        modes = [r["mode"] for r in gpu["step_log"]]
        print(f"  {arch}: losses {[round(x, 5) for x in gpu['losses']]}, "
              f"max rel err {rel:.3e}; params max abs err {gap:.3e}; "
              f"card steps {'/'.join(modes)}")
        if not rel <= LOSS_TOL:
            raise AssertionError(f"{arch}: losses {gpu['losses']} against "
                                 f"{cpu['losses']}")
        if modes != ["eager", "capture", "replay", "replay", "replay"]:
            raise AssertionError(f"{arch}: card steps {modes}")


def traced_ops(torch, fn) -> list:
    """``fn``'s device operations under ``torch.profiler`` as (name, start
    us, duration us), in start order; ``fn`` runs twice and the first run
    is the profiler's warm-up, discarded."""
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return sorted(((e.name, e.time_range.start, e.time_range.elapsed_us())
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith("ProfilerStep")),
                  key=lambda o: o[1])


def trace_text(ops, wall: float) -> tuple:
    """(line, figures) of a traced step: busy time, operations, idle
    share against the timed step's wall, and the gaps between
    consecutive operations (sum, median, largest)."""
    busy = sum(d for _, _, d in ops) / 1e3
    gaps = sorted(max(0.0, b[1] - (a[1] + a[2])) / 1e3
                  for a, b in zip(ops, ops[1:]))
    fig = {"wall_ms": wall, "busy_ms": busy, "ops": len(ops),
           "idle_share": (1 - busy / wall) if ops else float("nan"),
           "gap_ms": sum(gaps),
           "median_gap_us": gaps[len(gaps) // 2] * 1e3 if gaps else 0.0,
           "max_gap_ms": gaps[-1] if gaps else 0.0}
    line = (f"wall {wall:.1f} ms, device busy {busy:.1f} ms in {len(ops)} "
            f"device operations (profiled step), idle share "
            f"{fig['idle_share']:.3f}; gaps between operations "
            f"{fig['gap_ms']:.1f} ms in all, median "
            f"{fig['median_gap_us']:.1f} us, largest "
            f"{fig['max_gap_ms']:.2f} ms")
    return line, fig


def train_profile_phase(torch, trained: dict) -> dict:
    """6d: where a full-width training step's compute goes.  The
    launcher's train step on qwen2-1.5b with its state on the card (no
    paging: the compute part of a 6a step): eagerly, two steps to warm
    up, one timed, one under ``torch.profiler``; then staged on the same
    params and state (``StagedTrainStep``: one eager step, the capture,
    one replay timed, one traced).  The device's busy time against the
    timed step's wall gives each one's idle share.  Then the replays 6a
    traced with the state parked: H2D, D2H and compute busy, and the
    time copies ran beside compute, which must be more than zero in the
    streamed schedule."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.models.flags import Flags
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import (StepClock, make_train_step,
                                        make_train_step_, opt_state_init)
    from repro_torch.train.staged import StagedTrainStep

    cfg = get_config("qwen2-1.5b")
    S, Bg = TRAIN_RUN["seq_len"], TRAIN_RUN["global_batch"]
    model = build_model(cfg, Flags(remat=False, attn_chunk=S))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    opt = opt_state_init(params, True)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=6)
    step = make_train_step(model, ocfg, TRAIN_RUN["grad_accum"], True)
    data = SyntheticLM(DataConfig(cfg.vocab_size, S, Bg))
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch(0).items()}
    for _ in range(2):
        params, opt, _ = step(params, opt, batch)
    clock = StepClock("cuda")
    t = time.perf_counter()
    params, opt, _ = step(params, opt, batch, clock)
    wall = (time.perf_counter() - t) * 1e3
    # the trees live only here while the traced steps replace them: a
    # step holds the old state and the new, and a third copy would not fit
    trees = [params, opt]
    del params, opt

    def eager_step():
        trees[0], trees[1], _ = step(trees[0], trees[1], batch)
    ops = traced_ops(torch, eager_step)
    params, opt = trees
    del trees
    by_op = {}
    for name, _, us in ops:
        by_op[name] = by_op.get(name, 0.0) + us / 1e3
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:6]
    stages = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in clock.times.items())
    line, eager = trace_text(ops, wall)
    print(f"phase 6d: one qwen2-1.5b train step, state on the card, eager: "
          f"{line}; stages {stages} ms")
    for name, ms_ in top:
        print(f"  {ms_:8.2f} ms  {name[:100]}")
    if not ops:
        print("  the profiler recorded no device time: not measured")

    free_card(torch)
    staged = StagedTrainStep(make_train_step_(
        model, ocfg, TRAIN_RUN["grad_accum"], True), batch, device="cuda")
    modes = [staged(params, opt, batch)[1] for _ in range(2)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    modes.append(staged(params, opt, batch)[1])
    torch.cuda.synchronize()
    rwall = (time.perf_counter() - t) * 1e3
    rops = traced_ops(torch, lambda: staged(params, opt, batch))
    line, replay = trace_text(rops, rwall)
    print(f"  staged, replayed: {line}; steps {'/'.join(modes)}, capture "
          f"{staged.capture_s:.2f} s of host, graph pool "
          f"{staged.pool_bytes():,} B, device allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    if modes != ["eager", "capture", "replay"]:
        raise AssertionError(f"staged steps {modes}")
    if not rops:
        print("  the profiler recorded no device time in the replay: not "
              "measured")
    for label in ("streamed", "serial"):
        run = trained["runs"][label]
        print(f"  {label} replay of 6a (state parked), step "
              f"{TRAIN_TRACE_STEP} traced: {traced_text(run['traced'])}; "
              f"{run['log'][TRAIN_TRACE_STEP]['s'] * 1e3:.1f} ms traced "
              f"against {run['replay_ms']:.1f} ms untraced")
    if not trained["runs"]["streamed"]["traced"]["overlap"] > 0:
        raise AssertionError("the streamed replay ran no copy beside "
                             "compute")
    result = {**eager, "stage_ms": {k: v * 1e3
                                    for k, v in clock.times.items()},
              "replay": replay}
    del params, opt, step, staged
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
    modes = [r["mode"] for r in out["step_log"]]
    print(f"phase 6c: staged run resumed at step 10 after a failure at 12: "
          f"{out['steps']} steps ({modes.count('eager')} eager, "
          f"{modes.count('capture')} capture, {modes.count('replay')} "
          f"replays), losses max rel err {rel:.3e} against the "
          f"uninterrupted run, params max abs err {gap:.3e}; 30 steps: "
          f"loss {falls['first_loss']:.4f} -> {falls['final_loss']:.4f}")
    if out["steps"] != 10 or not rel <= LOSS_TOL:
        raise AssertionError(f"resumed {out['losses']} against "
                             f"{ref['losses'][10:]}")
    if modes != ["eager", "capture"] + ["replay"] * 8:
        raise AssertionError(f"resumed run's steps {modes}")
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
    return params, model.init_cache(B, S), ids(B, 1)


def replayed_train_s(torch, model, args) -> float:
    """8b's train step (AdamW's defaults, no accumulation or compression)
    staged through ``StagedTrainStep`` on the same params, state and
    batch, updated in place: one eager step, the capture, then the median
    of three replays, synchronized."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import make_train_step_
    from repro_torch.train.staged import StagedTrainStep
    staged = StagedTrainStep(make_train_step_(model, AdamWConfig()),
                             args[2], device="cuda")
    modes = [staged(*args)[1] for _ in range(2)]
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        modes.append(staged(*args)[1])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    if modes != ["eager", "capture"] + ["replay"] * 3:
        raise AssertionError(f"8b staged steps {modes}")
    return sorted(times)[1]


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
                args[1]["step"].zero_()     # the step advances it
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
        replay_s = replayed_train_s(torch, model, args) \
            if kind == "train" else None
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
              f"{step_s / terms.step_time_s:.2f}"
              + ("" if replay_s is None else
                 f", replayed through StagedTrainStep "
                 f"{replay_s * 1e3:.2f} ms (measured/roofline "
                 f"{replay_s / terms.step_time_s:.2f})")
              + f"; predicted "
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
                       "roofline_s": terms.step_time_s,
                       "replay_s": replay_s}
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
    q, views, table, lengths = granite_decode_inputs(torch)
    print(json.dumps({
        "paged_attention": both_times(
            lambda: pa.paged_attention_cuda(*paged)),
        "paged_attention_granite": both_times(cycled(
            lambda k, v: pa.paged_attention_cuda(q, k, v, table, lengths),
            views)),
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
    parser.add_argument("--dense-staged", metavar="ARCH[,ARCH]",
                        help="only build the kernels and run phase 3d for "
                        f"these configs (of {', '.join(DENSE_STAGED)})")
    parser.add_argument("--exaone", action="store_true",
                        help="only print phase 2's k-exaone-236b-a23b "
                        "rows, their launches from phase 4j")
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
        from repro_torch.configs.base import get_config
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
    if args.exaone:
        from repro_torch.kernels import paged_attention as pa
        rows = exaone_rows(torch, pa)
        lens, news, _, _ = workload()
        row_launches(rows, exaone_serve_phase(torch, lens, news))
        print(json.dumps({"kernels": rows}))
        print(card)
        return 0
    t = time.monotonic()
    logs = cuda_build.build(KERNEL_SOURCES)
    print(f"  built {', '.join(KERNEL_SOURCES)} in "
          f"{time.monotonic() - t:.1f}s")
    for name, log in logs.items():
        print_ptxas(name, log)

    lens, news, serve_lengths, rng = workload()
    if args.dense_staged:
        staged_dense_phase(torch, lens, news, card,
                           args.dense_staged.split(","))
        print(f"total {time.monotonic() - t_start:.1f}s")
        print(card)
        return 0
    # qwen2-1.5b's vocabulary (151,936 ids); the other phases draw theirs
    prompts = [(rng.integers(0, 151936, n).astype(np.int32), m)
               for n, m in zip(lens, news)]

    kernels = kernel_phase(torch, serve_lengths, max(lens))
    kernels.append(rwkv_kernel_phase(torch, max(lens)))
    served = serve_phases(torch, lens, news, prompts)
    staged_phase(torch, lens, news, card)
    staged_dense_phase(torch, lens, news, card)
    prefilled = staged_prefill_phase(torch, lens, card)
    quickstart_phase(torch)
    tier_stress_phase(torch)
    reduced_wave_phase(torch)
    seamless = seamless_phase(torch)
    served.update(new_serve_phases(torch, lens, news))
    served.update(exaone_serve_phase(torch, lens, news))
    swept = sweep_phase(torch, card)

    for k in kernels:
        k["path"] = k.get("path") or (
            "rwkv6-7b" if k["name"] in RWKV_KERNELS else "qwen2-1.5b")
    row_launches(kernels, {**served, "seamless-m4t-large-v2": seamless})
    for k in kernels:
        c, by_path = k.get("counter", k["name"]), k["launches_by_path"]
        by_path["qwen2-1.5b load sweep"] = \
            swept["pipelined"]["launches"].get(c, 0)
        for arch, res in prefilled.items():
            # three passes of 8 prompts through one staged engine: pass 1
            # eager, passes 2-3 counted through the graphs' replays
            if c in res["staged"]["launches"]:
                by_path[f"{arch} staged prefill (3p)"] = \
                    res["staged"]["launches"][c]
    reference_phase(torch, "qwen2-1.5b", (5, 13, 20, 9, 17), 64)
    reference_phase(torch, "rwkv6-7b", (5, 13, 20, 9, 17, 70), 128)
    reference_phase(torch, "dbrx-132b", (5, 13, 20, 9, 17), 64)
    reference_phase(torch, "mixtral-8x22b", (5, 13, 20, 9, 17), 64)
    reference_phase(torch, "hymba-1.5b", (5, 13, 20, 9, 17, 70), 128)
    for arch in ("granite-34b", "h2o-danube-3-4b", "command-r-plus-104b",
                 "chameleon-34b"):
        reference_phase(torch, arch, (5, 13, 20, 9, 17), 64)
    # the one reduced case in which the card's kernels run at head_dim 120
    reference_phase(torch, "h2o-danube-3-4b", (5, 13, 20, 9, 17), 64,
                    cfg=dataclasses.replace(get_config(
                        "h2o-danube-3-4b").reduced(), head_dim=120))
    encdec_reference_phase(torch)
    sweep_reference_phase(torch)
    trained = train_phase(torch, card)
    profiled = train_profile_phase(torch, trained)
    train_reference_phase(torch)
    resume_phase(torch)
    dryrun_phase(torch, card)
    for k in kernels:
        k["launches_by_path"]["qwen2-1.5b training"] = \
            trained["launches"].get(k.get("counter", k["name"]), 0)

    for name, res in served.items():
        print(f"serve {name}: {res['tokens_per_s']:.1f} tokens/s, mean TTFT "
              f"{res['mean_ttft_s'] * 1e3:.1f} ms, mean round "
              f"{res['mean_round_s'] * 1e3:.2f} ms, peak "
              f"{res['peak_mem_gib']:.2f} GiB, link bytes "
              f"{res['lmb_link_bytes']} on {card}")
    for name, res in served.items():
        if "decode_view" in res["breakdown"].get("bursts", {}):
            print(f"decode_view split {name}: "
                  f"{burst_text(res['breakdown'])} on {card}")
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
    ea, sr, sm = (trained["runs"][k] for k in ("eager", "serial",
                                                "streamed"))
    stages = ", ".join(f"{k} {v:.1f}" for k, v in ea["stage_ms"].items())
    print(f"train qwen2-1.5b: eager step {ea['step_ms']:.1f} ms ({stages} "
          f"ms), state {trained['state_bytes']:,} B each way at "
          f"{ea['in_gbps']:.1f} GB/s in, {ea['out_gbps']:.1f} GB/s out, "
          f"peak {ea['peak_gib']:.2f} GiB, losses "
          f"{[round(x, 4) for x in trained['losses']]}; replayed serial "
          f"{sr['replay_ms']:.1f} ms (peak {sr['peak_gib']:.2f} GiB, graph "
          f"pool {sr['pool_bytes']:,} B), streamed {sm['replay_ms']:.1f} ms "
          f"(peak {sm['peak_gib']:.2f} GiB, graph pool "
          f"{sm['pool_bytes']:,} B, copies beside compute "
          f"{sm['traced']['overlap'] * 1e3:.1f} ms); state on the card: "
          f"step {profiled['wall_ms']:.1f} ms, device busy "
          f"{profiled['busy_ms']:.1f} ms; replayed "
          f"{profiled['replay']['wall_ms']:.1f} ms, device busy "
          f"{profiled['replay']['busy_ms']:.1f} ms on {card}")
    sync_refusal_phase(torch)
    print(f"total {time.monotonic() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
