"""Hymba 1.5B — hybrid: parallel attention + mamba heads in each layer.

[arXiv:2411.13676; hf]  32L, d_model=1600, 25H (GQA kv=5), d_ff=5504,
vocab=32001 (padded 32256), head_dim=64, ssm_state=16.  Each block runs
attention and an SSM branch in parallel and fuses (mean of normed outputs).
25 heads don't divide the 16-way model axis: attention is REPLICATED over
model shards (tiny at 1.5B), FFN/SSM are TP-sharded.  Sliding window on
attention (Hymba uses SWA + few global layers; we use SWA 1024 throughout)
+ O(1) SSM state -> long_500k runs.  Meta-tokens are omitted (stub note).
"""
from repro_torch.configs.base import ArchConfig, HYBRID, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676; hf:nvidia/Hymba-1.5B-Base",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    sliding_window=1024,
    block_type=HYBRID,
    ssm_state=16,
    ssm_expand=2,
    ssm_heads=25,
))
