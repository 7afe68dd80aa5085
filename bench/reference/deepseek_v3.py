"""The plain reference of DeepSeek-V3 in float32 PyTorch, and its counts.

It imports nothing of the program, and of the benchmark only
``bench.counts``.  It takes a configuration file's ``"model"`` section
and the weights the benchmark drew from the seed: ``embed.table``,
``final_norm.scale``, ``readout.w`` and under ``trunk`` the layers' norms
and latent attention stacked on [L] (``attn``: ``wq_a``, ``q_norm``,
``wq_b``, ``wkv_a``, ``kv_norm``, ``wkv_b``, ``wo``, each ``w`` [in,
out]), the leading dense layers' MLP on [dense_layers] (``mlp``) and the
other layers' experts on [L - dense_layers] (``moe``).  It runs each
sequence whole, without a cache, batching or kernels, one layer at a time
over all the sequences (each layer's bf16 weights widened to float32 in
turn), with TF32 off.

The layer equations (``transformers``' ``modeling_deepseek_v3.py``):

* latent attention, expanded: ``q = wq_b(rms(wq_a(x)))`` split per head
  into ``qk_nope_head_dim`` and ``qk_rope_head_dim``; ``[c, k_r] =
  wkv_a(x)``, ``c = rms(c)``; ``[k_nope, v] = wkv_b(c)`` per head; RoPE
  on ``q_r`` and the shared ``k_r`` rotates adjacent pairs at YaRN's
  frequencies (``yarn_*``: the ramp between ``beta_fast`` and
  ``beta_slow`` rotations over ``yarn_original_max_position``, the
  factor ``yarn_factor``), cos and sin times YaRN's attention factor;
  causal softmax of ``[q_nope, q_r] . [k_nope, k_r]`` scaled by
  ``(nope + rope) ** -0.5 * mscale(factor, mscale_all_dim) ** 2``, times
  v, then ``wo``;
* block, pre-norm: ``h = x + attn(rms1(x))``, ``out = h + ffn(rms2(h))``;
  a final RMSNorm and the untied readout;
* FFN: the first ``dense_layers`` a SwiGLU of ``dense_d_ff``; every other
  layer ``s = sigmoid(h W_r)`` over all ``num_experts``, ``b = s +
  select_bias``, the ``n_group`` groups of ``num_experts / n_group``
  ranked by the sum of their two best ``b``, the choice the ``top_k`` of
  ``b`` inside the best ``topk_group`` groups, gates ``routed_scale *
  s_chosen / sum(s_chosen)``, and ``y = shared(h) + sum over the chosen
  experts e this chip holds (``0..experts_held-1``) of gate_e *
  expert_e(h)``, each a SwiGLU of ``d_ff``.  Nothing is dropped.

``quant="fp8"`` is the control: every matmul's operands (the router's
too) and the cached latent rows (``c`` and the roped ``k_r``) rounded to
float8 e4m3.

The counts (``bench/reference/__init__.py``) are this chip's work: a
prefill runs the expanded form (q/k ``nope + rope`` wide, v ``v_head_dim``
at ``num_heads`` heads), a decode step the absorbed one (each head's
scores over the ``kv_lora_rank + qk_rope_head_dim`` cached columns and
its values over the first ``kv_lora_rank``); ``wkv_b``'s weights count
once a token in both forms.  The held experts' operations are those of
the expected ``top_k * experts_held / num_experts`` routed pairs a token;
the shared expert, the dense layers and the router are counted whole.
``paged_least_s`` is the absorbed decode kernel's: each row's cached rows
read once a layer, its q and output, against both peaks; one more count,
:func:`expert_least_s`, is as ``k_exaone.py``'s.
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


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn_inv_freq(model: dict) -> torch.Tensor:
    """The RoPE part's inverse frequencies under YaRN (float64 on the
    host, then float32)."""
    dim = int(model["qk_rope_head_dim"])
    base = float(model["rope_theta"])
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64)
                           / dim)
    factor = float(model["yarn_factor"])
    if not factor:
        return extra.float()
    orig = float(model["yarn_original_max_position"])

    def dim_at(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(
            base))
    low = max(math.floor(dim_at(float(model["yarn_beta_fast"]))), 0)
    high = min(math.ceil(dim_at(float(model["yarn_beta_slow"]))), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low)
            / ((high - low) or 0.001)).clamp(0, 1)
    return (extra / factor * ramp + extra * (1 - ramp)).float()


def attention_factor(model: dict) -> float:
    f = float(model["yarn_factor"])
    if not f:
        return 1.0
    m, mall = float(model["yarn_mscale"]), float(model["yarn_mscale_all_dim"])
    return _mscale(f, m) / _mscale(f, mall) if m and mall else _mscale(f, 1)


def softmax_scale(model: dict) -> float:
    scale = (model["qk_nope_head_dim"] + model["qk_rope_head_dim"]) ** -0.5
    f, mall = float(model["yarn_factor"]), float(model["yarn_mscale_all_dim"])
    return scale * (_mscale(f, mall) ** 2 if f and mall else 1.0)


def _rope(x: torch.Tensor, model: dict) -> torch.Tensor:
    """x [S, ..., rope] at positions 0..S-1, adjacent pairs rotated; the
    pairs' first members first, then their second members."""
    S = x.shape[0]
    inv = yarn_inv_freq(model).to(x.device)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * inv
    f = attention_factor(model)
    s, c = torch.sin(ang) * f, torch.cos(ang) * f
    s = s.reshape(S, *([1] * (x.dim() - 2)), -1)
    c = c.reshape(S, *([1] * (x.dim() - 2)), -1)
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1)


def route(s: torch.Tensor, bias: torch.Tensor, model: dict) -> torch.Tensor:
    """The chosen experts' ids [T, top_k] from sigmoid scores s [T, E]:
    the top_k of ``s + bias`` within each token's ``topk_group`` best
    groups."""
    b = s + bias
    T, E = b.shape
    G = int(model["n_group"])
    if G > 1:
        g = b.reshape(T, G, E // G)
        best = g.topk(2, dim=-1).values.sum(dim=-1)
        keep = torch.zeros((T, G), dtype=torch.bool, device=b.device)
        keep[torch.arange(T, device=b.device)[:, None],
             best.topk(int(model["topk_group"]), dim=-1).indices] = True
        b = torch.where(keep[..., None], g, torch.full_like(g, -math.inf)
                        ).reshape(T, E)
    return torch.topk(b, int(model["top_k"]), dim=-1).indices


class Reference:
    def __init__(self, model: dict, params: Dict, quant: Optional[str] = None,
                 q_block: int = 256):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown precision {quant!r}")
        self.m = model
        self.p = params
        self.quant = quant
        self.q_block = q_block
        self.H = int(model["num_heads"])
        self.dn = int(model["qk_nope_head_dim"])
        self.dr = int(model["qk_rope_head_dim"])
        self.dv = int(model["v_head_dim"])
        self.dc = int(model["kv_lora_rank"])
        self.eps = float(model["norm_eps"])
        self.Ld = int(model["dense_layers"])
        self.scale = softmax_scale(model)

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
               "kv_norm": a["kv_norm"]["scale"][l].float()}
        for k in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"):
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
                out["moe"]["shared"] = {k: self._w(v["w"][i])
                                        for k, v in m["shared"].items()}
        return out

    def _swiglu(self, x, w_gate, w_up, w_down) -> torch.Tensor:
        return self._mm(F.silu(self._mm(x, w_gate)) * self._mm(x, w_up),
                        w_down)

    def _attention(self, x: torch.Tensor, w: Dict) -> torch.Tensor:
        """The expanded form over one sequence x [S, D] -> [S, D]."""
        S, H, dn, dc = x.shape[0], self.H, self.dn, self.dc
        q = self._mm(_rms(self._mm(x, w["wq_a"]), w["q_norm"], self.eps),
                     w["wq_b"]).reshape(S, H, dn + self.dr)
        ckr = self._mm(x, w["wkv_a"])
        c = _rms(ckr[:, :dc], w["kv_norm"], self.eps)
        k_r = _rope(ckr[:, dc:], self.m)
        if self.quant:
            c, k_r = _fp8(c, -1), _fp8(k_r, -1)
        kv = self._mm(c, w["wkv_b"]).reshape(S, H, dn + self.dv)
        q = torch.cat([q[..., :dn], _rope(q[..., dn:], self.m)], dim=-1)
        k = torch.cat([kv[..., :dn], k_r[:, None].expand(S, H, self.dr)],
                      dim=-1)
        v = kv[..., dn:]
        out = torch.empty((S, H, self.dv), dtype=torch.float32,
                          device=x.device)
        kk, vv = k.permute(1, 0, 2), v.permute(1, 0, 2)    # [H, S, .]
        for lo in range(0, S, self.q_block):
            hi = min(lo + self.q_block, S)
            s = torch.einsum("qhd,hsd->hqs", q[lo:hi], kk[:, :hi]) \
                * self.scale
            mask = torch.arange(hi, device=x.device)[None, :] <= \
                torch.arange(lo, hi, device=x.device)[:, None]
            p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
            out[lo:hi] = torch.einsum("hqs,hsd->qhd", p, vv[:, :hi])
        return self._mm(out.reshape(S, H * self.dv), w["wo"])

    def _experts(self, x: torch.Tensor, w: Dict) -> torch.Tensor:
        """The held experts' part of the routed sum, and the shared
        expert."""
        m = self.m
        s = torch.sigmoid(self._mm(x, w["router"]))            # [S, E]
        ids = route(s, w["select_bias"], m)
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

    def _block(self, x: torch.Tensor, w: Dict) -> torch.Tensor:
        x = x + self._attention(_rms(x, w["norm1"], self.eps), w)
        h = _rms(x, w["norm2"], self.eps)
        if "mlp" in w:
            f = self._swiglu(h, w["mlp"]["w_gate"], w["mlp"]["w_up"],
                             w["mlp"]["w_down"])
        else:
            f = self._experts(h, w["moe"])
        return x + f

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
                xs = [self._block(x, w) for x in xs]
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
def _expert_pairs(model: dict) -> float:
    """Expected routed pairs a token sends to this chip's experts."""
    return model["top_k"] * model["experts_held"] / model["num_experts"]


def _token_matmul_params(model: dict) -> float:
    """Weights one token multiplies through over all layers, the held
    experts at their expected pairs; the readout apart.  ``wkv_b`` counts
    once: expanded, a token's latent goes through it whole; absorbed, its
    key half multiplies q and its value half the output."""
    D, Fd, H = model["d_model"], model["d_ff"], model["num_heads"]
    dn, dr = model["qk_nope_head_dim"], model["qk_rope_head_dim"]
    dv, dc, dq = model["v_head_dim"], model["kv_lora_rank"], \
        model["q_lora_rank"]
    L, Ld = int(model["num_layers"]), int(model["dense_layers"])
    attn = (D * dq + dq * H * (dn + dr) + D * (dc + dr)
            + dc * H * (dn + dv) + H * dv * D)
    expert = 3 * D * Fd
    moe = (D * model["num_experts"] + model["shared_experts"] * expert
           + _expert_pairs(model) * expert)
    return L * attn + Ld * 3 * D * model["dense_d_ff"] + (L - Ld) * moe


def _prefill_attention_flops(model: dict, S: int) -> float:
    """One layer's causal expanded attention over S tokens: ``S(S+1)/2``
    pairs, each ``2 (nope + rope) + 2 v`` operations a head."""
    H = model["num_heads"]
    width = model["qk_nope_head_dim"] + model["qk_rope_head_dim"] \
        + model["v_head_dim"]
    return 2.0 * H * width * S * (S + 1) / 2


def _decode_key_flops(model: dict) -> float:
    """One cached token of the absorbed decode, one layer: each head's
    score over the row's ``kv_lora_rank + rope`` columns and its value
    over the first ``kv_lora_rank``."""
    dc, dr = model["kv_lora_rank"], model["qk_rope_head_dim"]
    return 2.0 * model["num_heads"] * (2 * dc + dr)


def prefill_flops(model: dict, S: int) -> float:
    L = int(model["num_layers"])
    return 2.0 * _token_matmul_params(model) * S \
        + L * _prefill_attention_flops(model, S) \
        + 2.0 * counts.readout_params(model)


def decode_flops(model: dict, context: int) -> float:
    L = int(model["num_layers"])
    return 2.0 * _token_matmul_params(model) \
        + L * _decode_key_flops(model) * (context + 1) \
        + 2.0 * counts.readout_params(model)


def paged_least_s(model: dict, lengths: Sequence[int],
                  max_pages: int) -> float:
    """The absorbed decode kernel's least time in one round, every layer:
    rows holding ``lengths`` tokens before the step read their ``n + 1``
    cached rows once, q (``kv_lora_rank + rope`` a head) read and the
    output (``kv_lora_rank`` a head) written once, the page table and
    lengths read."""
    e = counts.BYTES[model["dtype"]]
    H, dc = model["num_heads"], model["kv_lora_rank"]
    row = dc + model["qk_rope_head_dim"]
    B = len(lengths)
    live = sum(n + 1 for n in lengths)
    flops = _decode_key_flops(model) * live
    nbytes = (live * row + B * H * (row + dc)) * e + 4.0 * B * max_pages \
        + 4.0 * B
    return int(model["num_layers"]) * counts.least_seconds(flops, nbytes)


def flash_least_s(model: dict, S: int) -> float:
    """One prompt's expanded attention in the flash kernel, every layer:
    q and k (``nope + rope``), v and the output (``v_head_dim``) at
    ``num_heads`` heads read or written once."""
    e = counts.BYTES[model["dtype"]]
    H = model["num_heads"]
    qk = model["qk_nope_head_dim"] + model["qk_rope_head_dim"]
    nbytes = 2.0 * S * H * (qk + model["v_head_dim"]) * e
    return int(model["num_layers"]) * counts.least_seconds(
        _prefill_attention_flops(model, S), nbytes)


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
