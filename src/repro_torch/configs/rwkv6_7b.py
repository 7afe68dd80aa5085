"""RWKV-6 "Finch" 7B — attention-free, data-dependent decay.

[arXiv:2404.05892; hf]  32L, d_model=4096, d_ff(channel-mix)=14336,
vocab=65536, head_dim=64 (64 wkv heads).  No KV cache: decode state is a
constant-size [H, hd, hd] matrix per layer — `long_500k` runs.
"""
from repro_torch.configs.base import ArchConfig, RWKV6, register

CONFIG = register(ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    source="arXiv:2404.05892 (Finch); hf:RWKV/rwkv-6-world-7b",
    num_layers=32,
    d_model=4096,
    num_heads=64,          # wkv heads = d_model / rwkv_head_dim
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    head_dim=64,
    rwkv_head_dim=64,
    block_type=RWKV6,
    act="swiglu",          # channel-mix uses squared-relu-ish; swiglu stand-in
))
