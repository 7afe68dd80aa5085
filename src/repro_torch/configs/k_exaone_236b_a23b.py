"""K-EXAONE 236B-A23B — windowed and full attention, sigmoid-routed experts.

[hf:LGAI-EXAONE/K-EXAONE-236B-A23B config.json]  48L in the pattern LLLG
(36 layers with a 128-token sliding window and RoPE, 12 full layers
without positions), d_model=6144, 64H (GQA kv=8), head_dim=128, EXAONE 4.0
post-norm blocks with learned qk-norm.  Layer 0 is a dense SwiGLU of
18432; layers 1-47 route over 128 experts of 2048 (top-8, sigmoid scores
normalised over the chosen and scaled by 2.5, one shared expert).
vocab=153600, untied readout.  The MTP layer is not built.
"""
from repro_torch.configs.base import ArchConfig, MOE, register

CONFIG = register(ArchConfig(
    name="k-exaone-236b-a23b",
    family="moe",
    source="hf:LGAI-EXAONE/K-EXAONE-236B-A23B",
    num_layers=48,
    d_model=6144,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=153600,
    head_dim=128,
    block_type=MOE,
    sliding_window=128,
    window_pattern="LLLG",
    global_rope=False,
    post_norm=True,
    qk_norm=True,
    rope_theta=1000000.0,
    max_position=262144,
    num_experts=128,
    top_k=8,
    dense_layers=1,
    dense_d_ff=18432,
    router_score="sigmoid",
    experts_held=128,
    routed_scale=2.5,
    shared_experts=1,
    norm_eps=1e-5,
    act="swiglu",
    tie_embeddings=False,
))
