"""Granite 34B (code) — llama-arch with MQA (kv=1), 88 layers.

[arXiv:2405.04324; hf]  88L, d_model=6144, 48H (kv=1), d_ff=24576,
vocab=49152, head_dim=128.  Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig, DENSE, register

CONFIG = register(ArchConfig(
    name="granite-34b",
    family="dense",
    source="arXiv:2405.04324; hf:ibm-granite/granite-34b-code-base",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    block_type=DENSE,
    act="gelu",          # GPT-BigCode-style MLP (2 matmuls), not SwiGLU
))
