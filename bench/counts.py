"""Operations and bytes the served work needs, from shapes alone, and the
peaks of the card they are held against.

These are the yardstick's own counts: each input byte read once, each
output byte written once, and the operations the inputs need (a causal
prefill attends ``S(S+1)/2`` positions, a decode step its context and the
new token), whatever a kernel reads again or skips.  A share above 100 %
therefore means a count is wrong or a time misses part of the work.
``model`` is a configuration file's ``"model"`` section.
"""

from __future__ import annotations

from typing import Sequence

#: NVIDIA H100 SXM (data sheet): dense bf16 tensor-core rate, HBM3 rate
PEAK_BF16_FLOPS = 989.4e12
PEAK_HBM_BYTES_PER_S = 3.35e12

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _dims(model: dict):
    H, KV = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or model["d_model"] // H
    return H, KV, hd


def padded_vocab(model: dict) -> int:
    return -(-model["vocab_size"] // 256) * 256


def layer_matmul_params(model: dict) -> int:
    """Weights one token multiplies through in one layer."""
    D, F = model["d_model"], model["d_ff"]
    H, KV, hd = _dims(model)
    attn = D * H * hd + 2 * D * KV * hd + H * hd * D
    mlp = (3 if model.get("act", "swiglu") == "swiglu" else 2) * D * F
    return attn + mlp


def readout_params(model: dict) -> int:
    return padded_vocab(model) * model["d_model"]


def prefill_flops(model: dict, S: int) -> float:
    """A prompt of S tokens: every layer's matmuls for each token, causal
    attention over ``S(S+1)/2`` positions, the readout of the last token."""
    H, _, hd = _dims(model)
    L = model["num_layers"]
    attn = 4.0 * H * hd * S * (S + 1) / 2
    return L * (2.0 * layer_matmul_params(model) * S + attn) \
        + 2.0 * readout_params(model)


def decode_flops(model: dict, context: int) -> float:
    """One new token after ``context`` stored tokens: it attends
    ``context + 1`` positions in every layer, then the readout."""
    H, _, hd = _dims(model)
    L = model["num_layers"]
    return L * (2.0 * layer_matmul_params(model)
                + 4.0 * H * hd * (context + 1)) + 2.0 * readout_params(model)


def paged_attention_call(model: dict, lengths: Sequence[int],
                         max_pages: int) -> tuple:
    """(flops, bytes) of one layer's paged attention over a batch whose
    rows hold ``lengths`` tokens before the step: each row reads its
    ``n + 1`` keys and values once, its query, writes its output, and the
    page table and lengths are read."""
    H, KV, hd = _dims(model)
    e = BYTES[model["dtype"]]
    B = len(lengths)
    live = sum(n + 1 for n in lengths)
    flops = 4.0 * H * hd * live
    nbytes = 2.0 * live * KV * hd * e + 2.0 * B * H * hd * e \
        + 4.0 * B * max_pages + 4.0 * B
    return flops, nbytes


def flash_attention_call(model: dict, S: int) -> tuple:
    """(flops, bytes) of one layer's causal flash attention over S tokens:
    q, k, v read once, the output written once."""
    H, KV, hd = _dims(model)
    e = BYTES[model["dtype"]]
    flops = 4.0 * H * hd * S * (S + 1) / 2
    nbytes = (2.0 * S * H * hd + 2.0 * S * KV * hd) * e
    return flops, nbytes


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
