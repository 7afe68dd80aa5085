"""Architecture / run configuration schema.

One ``ArchConfig`` fully describes a model; one ``ShapeConfig`` describes an
input-shape cell (the assigned shapes).  ``reduced()`` produces the
small-but-same-family config used by CPU smoke tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

# block types
DENSE = "dense"          # attention + MLP
MOE = "moe"              # attention + mixture-of-experts MLP
RWKV6 = "rwkv6"          # attention-free: RWKV-6 time-mix + channel-mix
HYBRID = "hybrid"        # parallel attention + SSM heads (hymba)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


#: the assigned LM shape set (identical for all 10 archs)
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str                    # one of FAMILIES (pool tag)
    source: str                    # provenance note

    # trunk
    num_layers: int = 12
    d_model: int = 1024
    num_heads: int = 8
    num_kv_heads: int = 8
    d_ff: int = 4096
    vocab_size: int = 32000
    head_dim: Optional[int] = None  # default d_model // num_heads

    # block selection
    block_type: str = DENSE
    encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # attention details
    sliding_window: Optional[int] = None   # SWA window (tokens), None = full
    qkv_bias: bool = False                 # qwen2
    qk_norm: bool = False                  # chameleon
    rope_theta: float = 10000.0
    max_position: int = 1 << 20

    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM / hybrid (hymba) & rwkv
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_heads: int = 0             # decay groups (mamba2-style)
    rwkv_head_dim: int = 64

    # frontend stubs
    frontend: Optional[str] = None  # "audio" | "vision" | None

    # norm / act
    norm_eps: float = 1e-5
    act: str = "swiglu"            # "swiglu" | "gelu"
    tie_embeddings: bool = False

    # training
    dtype: str = "bfloat16"        # compute/param dtype
    remat: bool = True

    # --- derived -----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        # production practice: pad vocab so the embedding shards cleanly
        return pad_to(self.vocab_size, 256)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def param_count(self) -> int:
        """Analytic parameter count (embedding + trunk), for 6ND."""
        D, F, V, L = self.d_model, self.d_ff, self.padded_vocab, self.num_layers
        H, KV, hd = self.num_heads, self.num_kv_heads, self.head_dim_
        emb = V * D * (1 if self.tie_embeddings else 2)
        if self.block_type == RWKV6:
            tmix = 5 * D * D + D * hd  # r,k,v,g,o + decay lora (approx)
            cmix = 2 * D * F
            per_layer = tmix + cmix
        else:
            attn = D * H * hd + 2 * D * KV * hd + H * hd * D
            if self.block_type == MOE:
                mlp = self.num_experts * 3 * D * F + D * self.num_experts
            elif self.act == "swiglu":
                mlp = 3 * D * F
            else:
                mlp = 2 * D * F
            per_layer = attn + mlp
            if self.block_type == HYBRID:
                d_in = self.ssm_expand * D
                per_layer += 2 * D * d_in + d_in * self.ssm_state * 2 + d_in * D
        layers = self.num_layers + self.num_encoder_layers
        if self.encoder_decoder:
            # decoder layers also carry cross-attention
            per_layer_dec = per_layer + D * H * hd + 2 * D * KV * hd + H * hd * D
            return emb + self.num_encoder_layers * per_layer + \
                self.num_layers * per_layer_dec
        return emb + layers * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts)."""
        if self.block_type != MOE:
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.num_layers
        inactive = (self.num_experts - self.top_k) * 3 * D * F
        return self.param_count() - L * inactive

    def supports_long_context(self) -> bool:
        """Sub-quadratic decode w/ bounded KV working set (DESIGN.md §5)."""
        return (self.block_type in (RWKV6, HYBRID)
                or self.sliding_window is not None)

    def shape_cells(self) -> Tuple[str, ...]:
        cells = ["train_4k", "prefill_32k", "decode_32k"]
        if self.supports_long_context():
            cells.append("long_500k")
        return tuple(cells)

    # --- smoke-test reduction ----------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        scale = dict(
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads,
                                    4 * self.num_kv_heads // self.num_heads
                                    or 1)),
            d_ff=128,
            vocab_size=128,
            head_dim=16,
            max_position=2048,
            num_encoder_layers=2 if self.encoder_decoder else 0,
            sliding_window=16 if self.sliding_window else None,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=8 if self.block_type == HYBRID else self.ssm_state,
            ssm_heads=2 if self.ssm_heads else 0,
            rwkv_head_dim=16,
            dtype="float32",
            remat=False,
        )
        return dataclasses.replace(self, **scale)


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    if not _REGISTRY:
        _load_all()
    return tuple(sorted(_REGISTRY))


def _load_all() -> None:
    # import for side effect of register(); one per line so each alias
    # carries its own noqa (ruff reports F401 at the alias's line)
    from repro_torch.configs import chameleon_34b  # noqa: F401
    from repro_torch.configs import command_r_plus_104b  # noqa: F401
    from repro_torch.configs import dbrx_132b  # noqa: F401
    from repro_torch.configs import granite_34b  # noqa: F401
    from repro_torch.configs import h2o_danube_3_4b  # noqa: F401
    from repro_torch.configs import hymba_1_5b  # noqa: F401
    from repro_torch.configs import mixtral_8x22b  # noqa: F401
    from repro_torch.configs import qwen2_1_5b  # noqa: F401
    from repro_torch.configs import rwkv6_7b  # noqa: F401
    from repro_torch.configs import seamless_m4t_large_v2  # noqa: F401
