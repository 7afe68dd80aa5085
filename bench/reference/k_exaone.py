"""The plain reference of K-EXAONE-236B-A23B in float32 PyTorch, and its
counts.

It imports nothing of the program, and of the benchmark only
``bench.counts``.  It takes a configuration file's ``"model"`` section
and the weights the benchmark drew from the seed: ``embed.table``, ``final_norm.scale``, ``readout.w``
and under ``trunk`` the layers' norms and attention stacked on [L], the
leading dense layers' MLP on [dense_layers] (``mlp``) and the other
layers' experts on [L - dense_layers] (``moe``).  It runs each sequence
whole, without a cache, batching or kernels, one layer at a time over all
the sequences, with TF32 off.

The layer equations (EXAONE 4.0's block, DeepSeek-V3's router):

* attention: q, k, v without bias; per-head RMS qk-norm with a learned
  scale; RoPE (``rope_theta``) on the windowed layers ("L" of
  ``window_pattern``) only, the full layers ("G") use no positions; a
  windowed layer attends keys ``kpos > qpos - sliding_window``, a full
  layer every earlier key; softmax scaled by ``1/sqrt(hd)``;
* block: ``h = x + norm1(attn(x))``, ``out = h + norm2(ffn(h))``; a final
  RMSNorm and the untied readout;
* FFN: the first ``dense_layers`` a SwiGLU of ``dense_d_ff``; every other
  layer ``s = sigmoid(h W_r)`` over all ``num_experts``, the choice the
  ``top_k`` of ``s + select_bias``, gates ``routed_scale * s_chosen /
  sum(s_chosen)``, and ``y = shared(h) + sum over the chosen experts e
  this chip holds (``0..experts_held-1``) of gate_e * expert_e(h)``, each
  a SwiGLU of ``d_ff``.  Nothing is dropped.

``quant="fp8"`` is the control, as in ``model.py``: every matmul's
operands (the router's too) and the stored keys and values rounded to
float8 e4m3.

The counts (``bench/reference/__init__.py``) are this chip's work: a
windowed layer's keys are ``min(n, sliding_window)`` of the ``n`` a full
layer attends; the held experts' operations are those of the expected
``top_k * experts_held / num_experts`` routed pairs a token; the shared
expert, the dense layer and the router are counted whole.  One more count
of its own, :func:`expert_least_s`, is the least time of one model call's
held-expert products, which ``bench/metrics/expert_roofline.py`` reads.
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


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, heads, hd] at positions 0..S-1, each head's two halves
    rotated (``theta ** (-i / (hd/2))``)."""
    S, _, hd = x.shape
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    s, c = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _windowed(model: dict, l: int) -> bool:
    pat = model["window_pattern"]
    return pat[l % len(pat)] == "L"


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
        self.Ld = int(model["dense_layers"])

    # ------------------------------------------------------------ pieces
    def _w(self, leaf: torch.Tensor) -> torch.Tensor:
        """A [.., in, out] weight in float32; the control rounds it per
        output channel."""
        w = leaf.to(torch.float32)
        return _fp8(w, -2) if self.quant else w

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.quant:
            x = _fp8(x, -1)
        return x @ w

    def _layer(self, l: int) -> Dict[str, object]:
        t = self.p["trunk"]
        a = t["attn"]
        out = {"norm1": t["norm1"]["scale"][l].float(),
               "norm2": t["norm2"]["scale"][l].float(),
               "q_norm": a["q_norm"]["scale"][l].float(),
               "k_norm": a["k_norm"]["scale"][l].float()}
        for k in ("wq", "wk", "wv", "wo"):
            out[k] = self._w(a[k]["w"][l])
        if l < self.Ld:
            out["mlp"] = {k: self._w(v["w"][l]) for k, v in t["mlp"].items()}
        else:
            m = t["moe"]
            i = l - self.Ld
            out["moe"] = {
                "router": self._w(m["router"][i]),
                "select_bias": m["select_bias"][i].float(),
                **{k: self._w(m[k][i]) for k in ("w_gate", "w_up",
                                                 "w_down")}}
            if "shared" in m:
                out["shared"] = {k: self._w(v["w"][i])
                                 for k, v in m["shared"].items()}
        return out

    def _swiglu(self, x, w_gate, w_up, w_down) -> torch.Tensor:
        return self._mm(F.silu(self._mm(x, w_gate)) * self._mm(x, w_up),
                        w_down)

    def _attend(self, q, k, v, window: Optional[int]) -> torch.Tensor:
        """Causal attention, windowed if ``window``: q [S, H, hd], k/v
        [S, KV, hd] -> [S, H*hd]."""
        S = q.shape[0]
        G = self.H // self.KV
        kk = k.permute(1, 0, 2)                     # [KV, S, hd]
        vv = v.permute(1, 0, 2)
        out = torch.empty((S, self.H, self.hd), dtype=torch.float32,
                          device=q.device)
        scale = 1.0 / math.sqrt(self.hd)
        for lo in range(0, S, self.q_block):
            hi = min(lo + self.q_block, S)
            k0 = 0 if window is None else max(0, lo - window + 1)
            qb = q[lo:hi].reshape(hi - lo, self.KV, G, self.hd)
            s = torch.einsum("qkgd,ksd->kgqs", qb, kk[:, k0:hi]) * scale
            kpos = torch.arange(k0, hi, device=q.device)[None, :]
            qpos = torch.arange(lo, hi, device=q.device)[:, None]
            mask = kpos <= qpos
            if window is not None:
                mask &= kpos > qpos - window
            s = s.masked_fill(~mask, float("-inf"))
            p = torch.softmax(s, dim=-1)
            o = torch.einsum("kgqs,ksd->qkgd", p, vv[:, k0:hi])
            out[lo:hi] = o.reshape(hi - lo, self.H, self.hd)
        return out.reshape(S, self.H * self.hd)

    def _experts(self, x: torch.Tensor, w: Dict) -> torch.Tensor:
        """The held experts' part of the routed sum, and the shared
        expert."""
        m = self.m
        s = torch.sigmoid(self._mm(x, w["router"]))            # [S, E]
        ids = torch.topk(s + w["select_bias"], int(m["top_k"]),
                         dim=-1).indices
        g = torch.gather(s, 1, ids)
        g = g / (g.sum(dim=-1, keepdim=True) + 1e-20) \
            * float(m["routed_scale"])
        y = torch.zeros_like(x)
        for e in range(w["w_gate"].shape[0]):
            tok, choice = torch.nonzero(ids == e, as_tuple=True)
            if len(tok):
                ye = self._swiglu(x[tok], w["w_gate"][e], w["w_up"][e],
                                  w["w_down"][e])
                y.index_add_(0, tok, ye * g[tok, choice, None])
        if "shared" in w:
            sh = w["shared"]
            y = y + self._swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"])
        return y

    def _block(self, x: torch.Tensor, w: Dict, l: int) -> torch.Tensor:
        S = x.shape[0]
        m = self.m
        q = self._mm(x, w["wq"]).reshape(S, self.H, self.hd)
        k = self._mm(x, w["wk"]).reshape(S, self.KV, self.hd)
        v = self._mm(x, w["wv"]).reshape(S, self.KV, self.hd)
        q, k = _rms(q, w["q_norm"], self.eps), _rms(k, w["k_norm"], self.eps)
        windowed = _windowed(m, l)
        if windowed or m["global_rope"]:
            theta = float(m["rope_theta"])
            q, k = _rope(q, theta), _rope(k, theta)
        if self.quant:
            k, v = _fp8(k, -1), _fp8(v, -1)
        a = self._attend(q, k, v, int(m["sliding_window"]) if windowed
                         else None)
        x = x + _rms(self._mm(a, w["wo"]), w["norm1"], self.eps)
        if "mlp" in w:
            f = self._swiglu(x, w["mlp"]["w_gate"], w["mlp"]["w_up"],
                             w["mlp"]["w_down"])
        else:
            f = self._experts(x, {**w["moe"], **({"shared": w["shared"]}
                                                 if "shared" in w else {})})
        return x + _rms(f, w["norm2"], self.eps)

    # ------------------------------------------------------------ forward
    @torch.no_grad()
    def logits(self, seqs: Sequence[torch.Tensor],
               positions: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        """For each token sequence, its float32 logits [len(positions),
        padded vocab] at ``positions``."""
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            table = self.p["embed"]["table"]
            xs = [table[s.long()].to(torch.float32) for s in seqs]
            for l in range(int(self.m["num_layers"])):
                w = self._layer(l)
                xs = [self._block(x, w, l) for x in xs]
                del w
            final = self.p["final_norm"]["scale"].float()
            head = (self._w(self.p["readout"]["w"]) if "readout" in self.p
                    else self._w(table.T))
            out = []
            for x, pos in zip(xs, positions):
                xn = _rms(x[torch.as_tensor(list(pos), device=x.device)],
                          final, self.eps)
                out.append(self._mm(xn, head))
            return out
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags


# ------------------------------------------------------------------ counts
def _dims(model: dict):
    H, KV = model["num_heads"], model["num_kv_heads"]
    return H, KV, model.get("head_dim") or model["d_model"] // H


def _layers(model: dict):
    """(windowed, full) layer counts."""
    L = int(model["num_layers"])
    w = sum(_windowed(model, l) for l in range(L))
    return w, L - w


def _expert_pairs(model: dict) -> float:
    """Expected routed pairs a token sends to this chip's experts."""
    return model["top_k"] * model["experts_held"] / model["num_experts"]


def _token_matmul_params(model: dict) -> float:
    """Weights one token multiplies through over all layers, the held
    experts at their expected pairs; the readout apart."""
    D, Fd = model["d_model"], model["d_ff"]
    H, KV, hd = _dims(model)
    L, Ld = int(model["num_layers"]), int(model["dense_layers"])
    attn = D * H * hd + 2 * D * KV * hd + H * hd * D
    expert = 3 * D * Fd
    moe = (D * model["num_experts"] + model["shared_experts"] * expert
           + _expert_pairs(model) * expert)
    return L * attn + Ld * 3 * D * model["dense_d_ff"] + (L - Ld) * moe


def _prefill_keys(S: int, window: Optional[int]) -> float:
    """Keys the S queries of a causal prompt attend: S(S+1)/2, or with a
    window each query its last ``min(i + 1, window)``."""
    if window is None or S <= window:
        return S * (S + 1) / 2
    return window * (window + 1) / 2 + (S - window) * window


def prefill_flops(model: dict, S: int) -> float:
    H, _, hd = _dims(model)
    nw, nf = _layers(model)
    W = int(model["sliding_window"])
    attn = 4.0 * H * hd * (nw * _prefill_keys(S, W)
                           + nf * _prefill_keys(S, None))
    return 2.0 * _token_matmul_params(model) * S + attn \
        + 2.0 * counts.readout_params(model)


def decode_flops(model: dict, context: int) -> float:
    H, _, hd = _dims(model)
    nw, nf = _layers(model)
    W = int(model["sliding_window"])
    keys = nw * min(context + 1, W) + nf * (context + 1)
    return 2.0 * _token_matmul_params(model) + 4.0 * H * hd * keys \
        + 2.0 * counts.readout_params(model)


def _paged_call(model: dict, lengths: Sequence[int], max_pages: int,
                window: Optional[int]) -> tuple:
    """``counts.paged_attention_call`` for one layer, each row's keys cut
    to ``window``."""
    H, KV, hd = _dims(model)
    e = counts.BYTES[model["dtype"]]
    B = len(lengths)
    live = sum(n + 1 if window is None else min(n + 1, window)
               for n in lengths)
    flops = 4.0 * H * hd * live
    nbytes = 2.0 * live * KV * hd * e + 2.0 * B * H * hd * e \
        + 4.0 * B * max_pages + 4.0 * B
    return flops, nbytes


def paged_least_s(model: dict, lengths: Sequence[int],
                  max_pages: int) -> float:
    nw, nf = _layers(model)
    W = int(model["sliding_window"])
    return nw * counts.least_seconds(
        *_paged_call(model, lengths, max_pages, W)) \
        + nf * counts.least_seconds(
            *_paged_call(model, lengths, max_pages, None))


def flash_least_s(model: dict, S: int) -> float:
    H, KV, hd = _dims(model)
    e = counts.BYTES[model["dtype"]]
    nw, nf = _layers(model)
    W = int(model["sliding_window"])
    nbytes = (2.0 * S * H * hd + 2.0 * S * KV * hd) * e
    return sum(n * counts.least_seconds(4.0 * H * hd * _prefill_keys(S, w),
                                        nbytes)
               for n, w in ((nw, W), (nf, None)))


def expert_least_s(model: dict, tokens: int) -> float:
    """The least seconds of the held experts' products in one model call
    over ``tokens`` tokens (a prefill's prompt, a decode step's batch),
    over every expert layer: the expected routed pairs' operations, and
    the bytes of the held experts ``tokens`` tokens reach in expectation
    (``held * (1 - (1 - top_k / num_experts) ** tokens)`` experts' three
    matrices) with the tokens read and written once, against the card's
    peaks."""
    D, Fd = model["d_model"], model["d_ff"]
    e = counts.BYTES[model["dtype"]]
    E, K = model["num_experts"], model["top_k"]
    held = model["experts_held"]
    layers = int(model["num_layers"]) - int(model["dense_layers"])
    flops = 2.0 * 3 * D * Fd * tokens * _expert_pairs(model)
    reached = held * (1.0 - (1.0 - K / E) ** tokens)
    nbytes = reached * 3 * D * Fd * e + 2.0 * tokens * D * e
    return layers * counts.least_seconds(flops, nbytes)
