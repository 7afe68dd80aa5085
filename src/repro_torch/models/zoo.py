"""Model facade: init / loss / prefill / decode_step / decode_step_paged /
input_specs.

Port of ``repro.models.zoo`` for every config of the reference: the
decoder-only block types (DENSE, MOE, HYBRID, RWKV6) and the
encoder-decoder (seamless-m4t, ``models/encdec.py``; its prefill reads
the source frame embeddings ``batch["src_emb"]``).  A ``Model`` owns its
device: it runs on CUDA by default and raises when no card is present,
unless built with ``device="cpu"``.  Methods are functions of (params,
inputs) as in the reference; caches and pools are updated in place and
also returned.  ``loss`` is the training objective: the mean token
cross-entropy plus ``AUX_LOSS_WEIGHT`` times the MoE load-balancing loss.
``abstract_params``, ``input_specs`` and ``cache_specs`` give the dry run
(``launch/dryrun.py``) every input of a step as ``meta`` tensors: shapes
and dtypes, no storage.

A mixed stack (``cfg.mixed``: k-exaone-236b-a23b, deepseek-v3) reads
out through its own matrix (``readout``) where ``tie_embeddings`` is
false; every other model reads out through the embedding table, as in
the reference.  ``trace`` (a ``SpanTracer``, set by the serving engine)
lets its expert layers record their routing (``moe.route``).  How a
model's cache becomes KV pages is ``models/pages.py``'s, which the
serving store and engine take.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import DENSE, MOE, SHAPES, ArchConfig
from repro_torch.devices import resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models.flags import DEFAULT_FLAGS, Flags
from repro_torch.models.layers import (chunked_softmax_xent, dense,
                                       dense_init, dtype_of, embed_init,
                                       embed_logits, embed_lookup, rms_norm,
                                       rms_norm_init)
from repro_torch.models.transformer import (init_cache, mixed_init,
                                            stacked_layers_init,
                                            trunk_decode, trunk_decode_paged,
                                            trunk_prefill, trunk_train)

AUX_LOSS_WEIGHT = 0.01


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    flags: Flags = DEFAULT_FLAGS
    device: Any = "cuda"
    trace: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Seeded random params on the model's device, drawn from
        ``generator`` (which must live on that device)."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg = self.cfg
        params: Dict[str, Any] = {
            "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model,
                                dtype_of(cfg)),
            "final_norm": rms_norm_init(cfg.d_model, self.device),
        }
        if cfg.encoder_decoder:
            params["trunk"] = encdec_mod.encdec_init(generator, cfg)
        elif cfg.mixed:
            params["trunk"] = mixed_init(generator, cfg)
            if not cfg.tie_embeddings:
                params["readout"] = dense_init(
                    generator, cfg.d_model, cfg.padded_vocab, dtype_of(cfg),
                    scale=0.02)
        else:
            params["trunk"] = stacked_layers_init(generator, cfg,
                                                  cfg.num_layers)
        return params

    def abstract_params(self) -> Dict[str, Any]:
        """The params' shapes and dtypes as ``meta`` tensors, without
        allocating: :meth:`init` runs under ``FakeTensorMode`` with a CPU
        generator, whatever the model's device."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        cpu = dataclasses.replace(self, device="cpu")
        with FakeTensorMode():
            fake = cpu.init(torch.Generator())
        return _as_meta(fake)

    def _readout(self, params, x: torch.Tensor) -> torch.Tensor:
        xn = rms_norm(params["final_norm"], x, self.cfg.norm_eps)
        if "readout" in params:
            return dense(params["readout"], xn)
        return embed_logits(params["embed"], xn)

    # ------------------------------------------------------------------ loss
    def loss(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Scalar f32 loss of ``batch["tokens"]`` predicting
        ``batch["labels"]`` (both [B, S]); an encoder-decoder also reads
        ``batch["src_emb"]`` [B, S_src, D]."""
        cfg, flags = self.cfg, self.flags
        labels = batch["labels"]
        x = embed_lookup(params["embed"], batch["tokens"])
        if cfg.encoder_decoder:
            enc_out = encdec_mod.encode(params["trunk"], cfg,
                                        batch["src_emb"], flags)
            x = encdec_mod.decode_train(params["trunk"], cfg, x, enc_out,
                                        flags)
            aux = 0.0
        else:
            B, S = batch["tokens"].shape
            positions = torch.arange(S, device=x.device)[None].expand(B, S)
            x, aux = trunk_train(params["trunk"], cfg, x, positions, flags)
        xn = rms_norm(params["final_norm"], x, cfg.norm_eps)
        xent = chunked_softmax_xent(
            lambda xc: embed_logits(params["embed"], xc), xn, labels,
            chunk=min(flags.loss_chunk, labels.shape[1]),
            unroll=flags.unroll_loss)
        return xent + AUX_LOSS_WEIGHT * aux

    # --------------------------------------------------------------- prefill
    def init_cache(self, batch: int, seq_len: int,
                   src_len: Optional[int] = None,
                   device=None) -> Dict[str, Any]:
        """Zeroed decode cache on ``device`` (the model's by default)."""
        device = self.device if device is None else device
        if self.cfg.encoder_decoder:
            return encdec_mod.init_encdec_cache(self.cfg, batch, seq_len,
                                                src_len or seq_len, device)
        return init_cache(self.cfg, batch, seq_len, device)

    def prefill(self, params, batch: Dict[str, torch.Tensor],
                cache: Dict[str, Any]):
        """Prompt pass; returns (last-token logits [B, V], filled cache).
        A decoder-only model resets ``cache`` and fills it in place (the
        returned cache is ``cache``), so a staged engine prefills every
        prompt into one static cache.  An encoder-decoder encodes
        ``batch["src_emb"]`` [B, S_src, D], takes ``batch["tokens"]`` as
        the target prefix and returns a new cache."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed_lookup(params["embed"], tokens)
        if cfg.encoder_decoder:
            enc_out = encdec_mod.encode(params["trunk"], cfg,
                                        batch["src_emb"], self.flags)
            x, cache = encdec_mod.prefill(params["trunk"], cfg, x, enc_out,
                                          cache, self.flags)
        else:
            B, S = tokens.shape
            positions = torch.arange(S, device=tokens.device)[None].expand(
                B, S)
            x, cache = trunk_prefill(params["trunk"], cfg, x, positions,
                                     self.flags, cache, self.trace)
        logits = self._readout(params, x[:, -1:])[:, 0]
        return logits, cache

    # ---------------------------------------------------------------- decode
    def decode_step(self, params, cache: Dict[str, Any],
                    token: torch.Tensor):
        """token [B, 1] int32 -> (logits [B, V], cache updated in place)."""
        x = embed_lookup(params["embed"], token)
        if self.cfg.encoder_decoder:
            x, cache = encdec_mod.decode_step(params["trunk"], self.cfg, x,
                                              cache, self.flags)
        else:
            x, cache = trunk_decode(params["trunk"], self.cfg, x, cache,
                                    self.flags)
        logits = self._readout(params, x)[:, 0]
        return logits, cache

    def supports_paged_decode(self) -> bool:
        """Whether :meth:`decode_step_paged` covers this architecture (the
        paged pool keeps absolute positions, so SWA ring caches, the
        recurrent state of RWKV6 and HYBRID blocks and encoder-decoder
        caches stay on the dense slot path).  Per-layer windows
        (``window_pattern``) keep every token, and the paged kernel takes
        each layer's window."""
        cfg = self.cfg
        return (not cfg.encoder_decoder
                and (cfg.sliding_window is None or bool(cfg.window_pattern))
                and cfg.block_type in (DENSE, MOE))

    def decode_step_paged(self, params, pool: torch.Tensor,
                          page_table: torch.Tensor, lengths: torch.Tensor,
                          token: torch.Tensor):
        """One batched decode step straight against the paged KV pool.

        pool       [P, *page]            page-major (``models/pages.py``)
        page_table [B, MP] int32         pool page indices (-1 pad)
        lengths    [B] int32             tokens stored per sequence
        token      [B, 1] int32

        Returns (logits [B, V], pool): the new token's entries are written
        in place into each sequence's tail page across all layers — the
        kernels read per-layer strided views of the pool, which is never
        restacked.
        """
        x = embed_lookup(params["embed"], token)
        x = trunk_decode_paged(params["trunk"], self.cfg, x, pool,
                               page_table, lengths, self.flags, self.trace)
        logits = self._readout(params, x)[:, 0]
        return logits, pool


    # ------------------------------------------------------------- dry specs
    def input_specs(self, shape) -> Dict[str, torch.Tensor]:
        """``meta`` tensors for the batch the step of ``shape`` (a
        ``ShapeConfig`` or its name) takes."""
        if isinstance(shape, str):
            shape = SHAPES[shape]
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        tok = _meta((B, S), torch.int32)
        if shape.kind in ("train", "prefill"):
            specs = {"tokens": tok}
            if shape.kind == "train":
                specs["labels"] = tok
            if cfg.encoder_decoder:
                specs["src_emb"] = _meta((B, S, cfg.d_model), dtype_of(cfg))
            return specs
        if shape.kind == "decode":
            return {"token": _meta((B, 1), torch.int32)}
        raise ValueError(shape.kind)

    def cache_specs(self, shape) -> Dict[str, Any]:
        """The decode cache of ``shape`` as ``meta`` tensors; ``step`` is a
        0-d int32, as in every cache the port and the reference make."""
        if isinstance(shape, str):
            shape = SHAPES[shape]
        B, S = shape.global_batch, shape.seq_len
        return self.init_cache(B, S, device="meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _as_meta(tree):
    if isinstance(tree, dict):
        return {k: _as_meta(v) for k, v in tree.items()}
    return _meta(tree.shape, tree.dtype)


def build_model(cfg: ArchConfig, flags: Flags = DEFAULT_FLAGS,
                device="cuda") -> Model:
    return Model(cfg, flags, device)
