"""Command R+ 104B — dense GQA, no biases.

[hf:CohereForAI/c4ai-command-r-plus; unverified]  64L, d_model=12288,
96H (GQA kv=8), d_ff=33792, vocab=256000, head_dim=128.  Pure full
attention -> long_500k SKIPPED (DESIGN.md §5).  Largest assigned model:
primary beneficiary of LMB optimizer-state offload.
"""
from repro_torch.configs.base import ArchConfig, DENSE, register

CONFIG = register(ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-plus",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    head_dim=128,
    block_type=DENSE,
))
