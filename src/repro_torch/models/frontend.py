"""Modality frontend stubs (port of ``repro.models.frontend``).

The audio (seamless) and vision (chameleon VQ) frontends are not part of
the backbone; these helpers make the tensors the backbone expects:

  * audio  — frame embeddings [B, S, D], the stand-in for w2v-BERT
             features that the encoder consumes;
  * vision — a stub VQ tokenizer mapping an image grid to code ids in the
             (shared, early-fusion) vocabulary.

Both draw from an explicit ``torch.Generator`` on the generator's device.
"""

from __future__ import annotations

import torch


def audio_frames(gen: torch.Generator, batch: int, seq: int, d_model: int,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Precomputed frame embeddings, N(0, 0.1^2) drawn in f32 and cast."""
    return (torch.randn((batch, seq, d_model), generator=gen,
                        dtype=torch.float32, device=gen.device)
            * 0.1).to(dtype)


def vq_tokenize(gen: torch.Generator, batch: int, grid: int, vocab: int,
                image_vocab_offset: int = 4096) -> torch.Tensor:
    """Stub VQ-VAE: an image becomes grid*grid code ids in
    [image_vocab_offset, vocab), int32."""
    codes = torch.randint(0, vocab - image_vocab_offset, (batch, grid * grid),
                          generator=gen, device=gen.device)
    return (codes + image_vocab_offset).to(torch.int32)
