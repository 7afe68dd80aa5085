"""Model facade: init / prefill / decode_step / decode_step_paged.

Port of ``repro.models.zoo`` for DENSE decoder-only models.  A ``Model``
owns its device: it runs on CUDA by default and raises when no card is
present, unless built with ``device="cpu"``.  Methods are functions of
(params, inputs) as in the reference; caches and pools are updated in
place and also returned.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import DENSE, ArchConfig
from repro_torch.devices import resolve_device
from repro_torch.models.flags import DEFAULT_FLAGS, Flags
from repro_torch.models.layers import (dtype_of, embed_init, embed_logits,
                                       embed_lookup, rms_norm, rms_norm_init)
from repro_torch.models.transformer import (check_supported, init_cache,
                                            stacked_layers_init, trunk_decode,
                                            trunk_decode_paged, trunk_prefill)


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    flags: Flags = DEFAULT_FLAGS
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        check_supported(self.cfg)

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Seeded random params on the model's device, drawn from
        ``generator`` (which must live on that device)."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg = self.cfg
        return {
            "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model,
                                dtype_of(cfg)),
            "final_norm": rms_norm_init(cfg.d_model, self.device),
            "trunk": stacked_layers_init(generator, cfg, cfg.num_layers),
        }

    def _readout(self, params, x: torch.Tensor) -> torch.Tensor:
        xn = rms_norm(params["final_norm"], x, self.cfg.norm_eps)
        return embed_logits(params["embed"], xn)

    # --------------------------------------------------------------- prefill
    def init_cache(self, batch: int, seq_len: int) -> Dict[str, Any]:
        return init_cache(self.cfg, batch, seq_len, self.device)

    def prefill(self, params, batch: Dict[str, torch.Tensor],
                cache: Dict[str, Any]):
        """Prompt pass; returns (last-token logits [B, V], filled cache)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed_lookup(params["embed"], tokens)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        x, cache = trunk_prefill(params["trunk"], self.cfg, x, positions,
                                 self.flags, cache)
        logits = self._readout(params, x[:, -1:])[:, 0]
        return logits, cache

    # ---------------------------------------------------------------- decode
    def decode_step(self, params, cache: Dict[str, Any],
                    token: torch.Tensor):
        """token [B, 1] int32 -> (logits [B, V], cache updated in place)."""
        x = embed_lookup(params["embed"], token)
        x, cache = trunk_decode(params["trunk"], self.cfg, x, cache,
                                self.flags)
        logits = self._readout(params, x)[:, 0]
        return logits, cache

    def supports_paged_decode(self) -> bool:
        """Whether :meth:`decode_step_paged` covers this architecture (the
        paged pool keeps absolute positions, so SWA ring caches stay on
        the dense slot path)."""
        cfg = self.cfg
        return (not cfg.encoder_decoder and cfg.sliding_window is None
                and cfg.block_type == DENSE)

    def decode_step_paged(self, params, pool: torch.Tensor,
                          page_table: torch.Tensor, lengths: torch.Tensor,
                          token: torch.Tensor):
        """One batched decode step straight against the paged KV pool.

        pool       [P, L, 2, T, KV, hd]  page-major (PagedKVStore layout)
        page_table [B, MP] int32         pool page indices (-1 pad)
        lengths    [B] int32             tokens stored per sequence
        token      [B, 1] int32

        Returns (logits [B, V], pool): the new token's K/V is written in
        place into each sequence's tail page across all layers — the
        kernels read per-layer strided views of the pool, which is never
        restacked.
        """
        x = embed_lookup(params["embed"], token)
        x = trunk_decode_paged(params["trunk"], self.cfg, x, pool,
                               page_table, lengths, self.flags)
        logits = self._readout(params, x)[:, 0]
        return logits, pool


def build_model(cfg: ArchConfig, flags: Flags = DEFAULT_FLAGS,
                device="cuda") -> Model:
    return Model(cfg, flags, device)
