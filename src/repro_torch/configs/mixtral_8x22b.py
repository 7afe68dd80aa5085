"""Mixtral 8x22B — MoE 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf]  56L, d_model=6144, 48H (GQA kv=8), d_ff=16384 per
expert, vocab=32768, head_dim=128, SWA window 4096.  8 experts on a 16-way
model axis: expert FFN hidden dim is TP-sharded 16-way instead (experts
replicated across model shards in pairs is NOT used; see sharding rules).
SWA -> bounded KV -> long_500k runs.
"""
from repro_torch.configs.base import ArchConfig, MOE, register

CONFIG = register(ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    source="arXiv:2401.04088; hf:mistralai/Mixtral-8x22B-v0.1",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    sliding_window=4096,
    block_type=MOE,
    num_experts=8,
    top_k=2,
))
