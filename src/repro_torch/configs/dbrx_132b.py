"""DBRX 132B — fine-grained MoE, 16 experts top-4.

[hf:databricks/dbrx-base; unverified]  40L, d_model=6144, 48H (GQA kv=8),
d_ff=10752 per expert, vocab=100352, head_dim=128.  MoE 16e/top-4: experts
shard 1:1 over the 16-way model axis (pure EP).  Full attention ->
long_500k skipped.  LMB additionally pages inactive expert weights.
"""
from repro_torch.configs.base import ArchConfig, MOE, register

CONFIG = register(ArchConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    head_dim=128,
    block_type=MOE,
    num_experts=16,
    top_k=4,
))
