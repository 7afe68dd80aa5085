"""DeepSeek-V3 — latent attention and group-limited sigmoid-routed experts.

[hf:deepseek-ai/DeepSeek-V3 config.json]  61L, d_model=7168, 128H of
multi-head latent attention (MLA) on every layer: q through a rank-1536
projection, k and v through a rank-512 latent, each head's q/k 128 wide
without positions and 64 wide with YaRN RoPE (factor 40 over 4096
positions), v 128 wide; the cache keeps the 576-wide latent row a token.
Layers 0-2 are dense SwiGLU of 18432; layers 3-60 route over 256 experts
of 2048 (top-8 among the 4 best of 8 groups, sigmoid scores with a
selection bias, normalised over the chosen and scaled by 2.5, one shared
expert).  vocab=129280, untied readout, pre-norm blocks.  ``head_dim``
is the expanded form's q/k width (128 + 64).  The MTP layer is not
built.  DeepSeek-R1 has the same architecture.
"""
from repro_torch.configs.base import ArchConfig, MOE, register

CONFIG = register(ArchConfig(
    name="deepseek-v3",
    family="moe",
    source="hf:deepseek-ai/DeepSeek-V3",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=2048,
    vocab_size=129280,
    head_dim=192,
    block_type=MOE,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10000.0,
    yarn_factor=40.0,
    yarn_original_max_position=4096,
    yarn_beta_fast=32.0,
    yarn_beta_slow=1.0,
    yarn_mscale=1.0,
    yarn_mscale_all_dim=1.0,
    max_position=163840,
    num_experts=256,
    top_k=8,
    n_group=8,
    topk_group=4,
    dense_layers=3,
    dense_d_ff=18432,
    router_score="sigmoid",
    experts_held=256,
    routed_scale=2.5,
    shared_experts=1,
    norm_eps=1e-6,
    act="swiglu",
    tie_embeddings=False,
))
