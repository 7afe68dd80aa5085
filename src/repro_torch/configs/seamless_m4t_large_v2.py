"""SeamlessM4T large v2 — encoder-decoder, multimodal (audio backbone stub).

[arXiv:2308.11596; hf]  24 encoder + 24 decoder layers, d_model=1024,
16 heads (kv=16, i.e. MHA), d_ff=8192, vocab=256206 (padded to 256256).
The speech frontend (w2v-BERT conformer feature extractor) is a STUB:
`input_specs()` supplies precomputed frame embeddings [B, S, D].
Full attention -> long_500k skipped (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig, DENSE, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    source="arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large",
    num_layers=24,             # decoder
    num_encoder_layers=24,     # encoder
    encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    block_type=DENSE,
    act="gelu",
    frontend="audio",
))
