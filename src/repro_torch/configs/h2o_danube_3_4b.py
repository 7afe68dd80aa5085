"""H2O-Danube3 4B — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified]  24L, d_model=3840, 32H (GQA kv=8),
d_ff=10240, vocab=32000, head_dim=120.  SWA window 4096 (mistral-style)
-> bounded KV working set -> long_500k runs.
"""
from repro_torch.configs.base import ArchConfig, DENSE, register

CONFIG = register(ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    source="arXiv:2401.16818; hf:h2oai/h2o-danube3-4b-base",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,
    sliding_window=4096,
    block_type=DENSE,
))
