"""How a model's cache becomes KV pages: the page's row layout, and the
rows of a prefill's cache and of a dense decode step.

A page holds ``page_tokens`` tokens of every layer's entries at once.
Per-head K/V attention stacks K and V: ``[L, 2, T, KV, hd]``, tokens on
axis 2.  Latent attention (``models/mla.py``) keeps one row a token and
layer: ``[L, T, latent_width]``, tokens on axis 1.  The serving store
(``serve/kv_cache.PagedKVStore``), the engine and the staged step take
the layout from here (through ``Model``) and build none of their own.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import mla as mla_mod


@dataclasses.dataclass(frozen=True)
class PageLayout:
    """One page's shape (without the page axis), its token axis, and
    whether it holds latent rows (one row a token and layer, no K/V
    split)."""

    shape: Tuple[int, ...]
    token_axis: int
    latent: bool = False


def page_layout(cfg, page_tokens: int,
                n_layers: Optional[int] = None) -> PageLayout:
    L = n_layers or cfg.num_layers
    if cfg.attention == "mla":
        return PageLayout((L, page_tokens, mla_mod.latent_width(cfg)), 1,
                          latent=True)
    return PageLayout((L, 2, page_tokens, cfg.num_kv_heads, cfg.head_dim_),
                      2)


def cache_rows(cache: Dict[str, Any], length: int
               ) -> Optional[torch.Tensor]:
    """A B = 1 prefill cache's first ``length`` tokens in the page's row
    layout (the token axis ``length`` long), or None for a cache that
    keeps no entry a token (RWKV6's recurrent state)."""
    if "latent" in cache:
        return cache["latent"][:, 0, :length]          # [L, len, latent]
    if "k" not in cache:
        return None
    return torch.stack([cache["k"][:, 0, :length],
                        cache["v"][:, 0, :length]], dim=1)


def step_rows(cache: Dict[str, Any], position: int
              ) -> Optional[torch.Tensor]:
    """The entries a dense decode step just wrote for the token at
    ``position`` (kept on the host), from its ring slot, in the page's row
    layout with one token, or None for a cache without entries a token."""
    if "k" not in cache:
        return None
    C = cache["k"].shape[2]
    slot = position % C
    return torch.stack([cache["k"][:, 0, slot:slot + 1],
                        cache["v"][:, 0, slot:slot + 1]], dim=1)
