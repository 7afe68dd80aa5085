"""The plain reference: the served models' forward pass in float32 PyTorch.

It imports nothing of the program.  It takes a configuration file's
``"model"`` section and the weights the benchmark drew from the seed (as a
tree of tensors: ``embed.table``, ``final_norm.scale``, and under ``trunk``
each layer's leaves stacked on a leading axis), and runs each sequence
whole, without a cache, batching or kernels, one layer at a time over all
the sequences so that only one layer's weights are ever held in float32.
TF32 is off while it runs.

The architecture is the one the program is configured to run (the
configuration file lists where that departs from the published model):
pre-norm blocks with RMSNorm (statistics in float32, a learned scale);
attention with ``num_kv_heads`` groups, optional per-head RMS qk-norm
without a scale, rotary embeddings on the two halves of each head
(``theta ** (-i / (hd/2))``), causal softmax scaled by ``1/sqrt(hd)``;
an MLP that is SwiGLU (``w_down(silu(w_gate x) * w_up x)``) or GELU with
the tanh approximation (``w_down(gelu(w_up x))``); a final RMSNorm and
logits against the embedding table.

``quant="fp8"`` is the control: the same pass with every matmul's operands
and the stored keys and values rounded to float8 e4m3 (weights per output
channel, activations per token, keys and values per token and head, each
scaled to the format's largest finite value 448), the lower precision a
deployment of a bfloat16 model would try next.

The counts (``bench/reference/__init__.py``) are ``bench.counts``'s dense
arithmetic: every layer the same, attending its whole context.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from bench import counts

FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (returned in float32)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _rms(x: torch.Tensor, scale: Optional[torch.Tensor], eps: float
         ) -> torch.Tensor:
    y = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return y if scale is None else y * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, heads, hd] at positions 0..S-1."""
    S, _, hd = x.shape
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    s, c = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


class Reference:
    def __init__(self, model: dict, params: Dict, quant: Optional[str] = None,
                 q_block: int = 1024):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown precision {quant!r}")
        self.m = model
        self.p = params
        self.quant = quant
        self.q_block = q_block
        self.H = model["num_heads"]
        self.KV = model["num_kv_heads"]
        self.hd = model.get("head_dim") or model["d_model"] // self.H
        self.eps = float(model["norm_eps"])

    # ------------------------------------------------------------ pieces
    def _w(self, leaf: torch.Tensor) -> torch.Tensor:
        w = leaf.to(torch.float32)
        return _fp8(w, 0) if self.quant else w

    def _mm(self, x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.quant:
            x = _fp8(x, -1)
        y = x @ w
        return y if b is None else y + b

    def _layer(self, l: int) -> Dict[str, torch.Tensor]:
        t = self.p["trunk"]
        out = {"norm1": t["norm1"]["scale"][l].float(),
               "norm2": t["norm2"]["scale"][l].float()}
        for k in ("wq", "wk", "wv", "wo"):
            out[k] = self._w(t["attn"][k]["w"][l])
            if "b" in t["attn"][k]:
                out[k + "_b"] = t["attn"][k]["b"][l].float()
        for k in t["mlp"]:
            out[k] = self._w(t["mlp"][k]["w"][l])
        return out

    def _attend(self, q, k, v) -> torch.Tensor:
        """Causal attention: q [S, H, hd], k/v [S, KV, hd] -> [S, H*hd]."""
        S = q.shape[0]
        G = self.H // self.KV
        kk = k.permute(1, 0, 2)                     # [KV, S, hd]
        vv = v.permute(1, 0, 2)
        out = torch.empty((S, self.H, self.hd), dtype=torch.float32,
                          device=q.device)
        scale = 1.0 / math.sqrt(self.hd)
        for lo in range(0, S, self.q_block):
            hi = min(lo + self.q_block, S)
            qb = q[lo:hi].reshape(hi - lo, self.KV, G, self.hd)
            s = torch.einsum("qkgd,ksd->kgqs", qb, kk[:, :hi]) * scale
            mask = (torch.arange(hi, device=q.device)[None, :]
                    <= torch.arange(lo, hi, device=q.device)[:, None])
            s = s.masked_fill(~mask, float("-inf"))
            p = torch.softmax(s, dim=-1)
            o = torch.einsum("kgqs,ksd->qkgd", p, vv[:, :hi])
            out[lo:hi] = o.reshape(hi - lo, self.H, self.hd)
        return out.reshape(S, self.H * self.hd)

    def _block(self, x: torch.Tensor, w: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
        S = x.shape[0]
        h = _rms(x, w["norm1"], self.eps)
        q = self._mm(h, w["wq"], w.get("wq_b")).reshape(S, self.H, self.hd)
        k = self._mm(h, w["wk"], w.get("wk_b")).reshape(S, self.KV, self.hd)
        v = self._mm(h, w["wv"], w.get("wv_b")).reshape(S, self.KV, self.hd)
        if self.m.get("qk_norm"):
            q, k = _rms(q, None, self.eps), _rms(k, None, self.eps)
        theta = float(self.m["rope_theta"])
        q, k = _rope(q, theta), _rope(k, theta)
        if self.quant:
            k, v = _fp8(k, -1), _fp8(v, -1)
        x = x + self._mm(self._attend(q, k, v), w["wo"])
        h = _rms(x, w["norm2"], self.eps)
        if self.m.get("act", "swiglu") == "swiglu":
            a = F.silu(self._mm(h, w["w_gate"])) * self._mm(h, w["w_up"])
        else:
            a = F.gelu(self._mm(h, w["w_up"]), approximate="tanh")
        return x + self._mm(a, w["w_down"])

    # ------------------------------------------------------------ forward
    @torch.no_grad()
    def logits(self, seqs: Sequence[torch.Tensor],
               positions: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        """For each token sequence, its float32 logits [len(positions),
        padded vocab] at ``positions`` (the logits there predict the next
        token)."""
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            table = self.p["embed"]["table"]
            xs = [table[s.long()].to(torch.float32) for s in seqs]
            for l in range(int(self.m["num_layers"])):
                w = self._layer(l)
                xs = [self._block(x, w) for x in xs]
                del w
            final = self.p["final_norm"]["scale"].float()
            e = table.to(torch.float32)
            if self.quant:
                e = _fp8(e, -1)
            out = []
            for x, pos in zip(xs, positions):
                xn = _rms(x[torch.as_tensor(list(pos), device=x.device)],
                          final, self.eps)
                out.append(self._mm(xn, e.T))
            return out
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags


# ------------------------------------------------------------------ counts
prefill_flops = counts.prefill_flops
decode_flops = counts.decode_flops


def paged_least_s(model: dict, lengths: Sequence[int],
                  max_pages: int) -> float:
    return model["num_layers"] * counts.least_seconds(
        *counts.paged_attention_call(model, lengths, max_pages))


def flash_least_s(model: dict, S: int) -> float:
    return model["num_layers"] * counts.least_seconds(
        *counts.flash_attention_call(model, S))
