"""Run-time (non-architecture) flags: performance knobs for hillclimbing.

Baseline = defaults.  Each knob is an EXPERIMENTS.md §Perf lever; flipping
them must never change results beyond numerics.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Flags:
    #: q-chunk size for the chunked-attention XLA path
    attn_chunk: int = 512
    #: statically skip fully-masked K blocks (causal/SWA) in the unrolled
    #: q-chunk loop — FLOP reduction visible in cost_analysis
    causal_skip: bool = False
    #: sequence-axis chunk for the cross-entropy readout
    loss_chunk: int = 512
    #: use Pallas TPU kernels for attention/rwkv/ssm hot spots (TPU only;
    #: the CPU dry-run lowers the XLA path)
    use_kernels: bool = False
    #: activation rematerialization for the scanned layer stack
    remat: bool = True
    #: remat policy: "nothing" (recompute everything; min memory) or
    #: "dots" (save matmul outputs; less recompute, more memory)
    remat_policy: str = "nothing"
    #: apply Megatron-SP activation sharding constraints (needs an active
    #: activation_mesh context; no-op otherwise)
    act_constraints: bool = True
    #: offload optimizer state to the LMB tier inside the step (in the
    #: reference, TPU only; in the port, the staged train step on a card
    #: streams it, ``launch.train.run(offload_opt=True)``)
    offload_opt_state: bool = False
    #: chunk length for rwkv/ssm chunked scans
    scan_chunk: int = 64
    #: unroll the layer stack as a python loop (analysis + perf experiments;
    #: cost_analysis counts while-loop bodies once, so the dry-run measures
    #: body cost via unroll@L=2 minus scan@L=2)
    unroll_layers: bool = False
    #: unroll inner sequence-chunk scans (wkv/ssd) the same way
    unroll_scans: bool = False
    #: unroll the chunked-loss readout loop (few copies; keeps the readout
    #: matmul visible to cost_analysis at its true trip count)
    unroll_loss: bool = True
    #: fold the rwkv token-shift mix into fused projection weights:
    #: (mu*x + (1-mu)*xs) @ W == x @ (diag(mu)W) + xs @ (diag(1-mu)W) —
    #: 5 projections share ONE gathered x and ONE gathered xs (collective
    #: term lever; numerically identical modulo float association)
    fuse_rwkv_proj: bool = False
    #: tokens per MoE dispatch group (bounds [g,E,C] one-hot tensors)
    moe_group: int = 1024


DEFAULT_FLAGS = Flags()
