"""Chameleon 34B — early-fusion VLM with VQ image tokens, qk-norm.

[arXiv:2405.09818; unverified]  48L, d_model=8192, 64H (GQA kv=8),
d_ff=22016, vocab=65536 (text + VQ image codes in one vocabulary),
head_dim=128, qk-norm for training stability.  The VQ-VAE image tokenizer
is a STUB: images arrive as token ids (early fusion means the backbone is
a plain LM).  Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig, DENSE, register

CONFIG = register(ArchConfig(
    name="chameleon-34b",
    family="vlm",
    source="arXiv:2405.09818; hf:facebook/chameleon-30b",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    head_dim=128,
    qk_norm=True,
    block_type=DENSE,
    frontend="vision",
))
