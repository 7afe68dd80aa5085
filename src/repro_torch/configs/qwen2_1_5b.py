"""Qwen2 1.5B — dense GQA with QKV bias.

[arXiv:2407.10671; hf]  28L, d_model=1536, 12H (GQA kv=2), d_ff=8960,
vocab=151936, head_dim=128.  Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig, DENSE, register

CONFIG = register(ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    source="arXiv:2407.10671; hf:Qwen/Qwen2-1.5B",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    block_type=DENSE,
))
