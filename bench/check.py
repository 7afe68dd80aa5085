"""Decide ``correct``: the served tokens against the plain reference.

After the window, a sample of the requests the engine finished is drawn
from the seed, always with the longest of them in it, until it holds
``check.served_tokens_at_least`` served tokens.  For each, the
configuration's plain reference (the ``Reference`` of the architecture
file its ``reference`` names, ``bench/reference/__init__.py``) runs once over the prompt and the served tokens (the logits at
the prompt's last position predict the first served token, and so on) and
reads, at every served token, how far that token's logit lies below the
reference's best there.  Two numbers are compared, each with the limit the
configuration file gives it (``check.at_most``): the widest such gap over
the sample, and their mean over every served token of it.  Each limit lies
between what sound runs of the program read and what the control (the
same ``Reference`` in float8, put in the program's place and judged by the
same comparison: ``bench/control.py``) reads, as ``PERF.md`` records.
A sample with fewer served tokens than ``check.served_tokens_at_least``
(the engine finished too few requests) fails: too few to judge.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def draw_sample(finished: Sequence[Tuple[int, np.ndarray, List[int]]],
                tokens: int, seed: int
                ) -> List[Tuple[int, np.ndarray, List[int]]]:
    """Finished ``(rid, prompt, served)`` triples drawn from ``seed``: the
    longest (prompt and served tokens), then others in the seed's order
    until the sample holds ``tokens`` served tokens (or all of them)."""
    done = sorted(finished, key=lambda f: f[0])
    if not done:
        return []
    longest = max(range(len(done)),
                  key=lambda i: (len(done[i][1]) + len(done[i][2]), -i))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng([seed, 2])
    pick, have = [longest], len(done[longest][2])
    for i in rng.permutation(rest):
        if have >= tokens:
            break
        pick.append(int(i))
        have += len(done[i][2])
    return [done[pick[0]]] + [done[i] for i in sorted(pick[1:])]


def sequences(sample, device) -> Tuple[List[torch.Tensor], List[List[int]]]:
    """The token sequences the reference runs (prompt and every served
    token but the last) and the positions whose logits predict the served
    tokens."""
    seqs, positions = [], []
    for _, prompt, served in sample:
        toks = np.concatenate([np.asarray(prompt, np.int64),
                               np.asarray(served[:-1], np.int64)])
        seqs.append(torch.as_tensor(toks, device=device))
        p0 = len(prompt) - 1
        positions.append(list(range(p0, p0 + len(served))))
    return seqs, positions


def gaps(logits: torch.Tensor, tokens: Sequence[int]) -> np.ndarray:
    """How far each token's logit lies below the best at its position."""
    idx = torch.as_tensor(list(tokens), device=logits.device)[:, None]
    chosen = torch.gather(logits, 1, idx)[:, 0]
    return (logits.max(dim=1).values - chosen).cpu().numpy()


def judge(plain: type, model: dict, params: Dict, sample, *,
          control: bool = False) -> Dict[str, object]:
    """``plain`` (an architecture file's ``Reference``) over
    ``sample``: the widest and mean gap of the served tokens, and with
    ``control`` also those of the tokens the float8 control puts first at
    the same positions."""
    device = params["embed"]["table"].device
    seqs, positions = sequences(sample, device)
    ref = plain(model, params).logits(seqs, positions)
    served = [gaps(lg, s) for lg, (_, _, s) in zip(ref, sample)]
    out = {"tokens": int(sum(len(g) for g in served)),
           **_widest_and_mean(served),
           "per_request": [float(g.max()) for g in served if len(g)]}
    if control:
        low = plain(model, params, quant="fp8").logits(seqs, positions)
        cg = [gaps(r, lg.argmax(dim=1).tolist()) for r, lg in zip(ref, low)]
        out["control"] = _widest_and_mean(cg)
    return out


def _widest_and_mean(per_request: List[np.ndarray]) -> Dict[str, float]:
    allg = np.concatenate(per_request) if per_request else np.zeros(0)
    if not len(allg):
        return {"widest_gap": float("nan"), "mean_gap": float("nan")}
    return {"widest_gap": float(allg.max()), "mean_gap": float(allg.mean())}


def verdict(result: Dict[str, object], limits: dict
            ) -> Tuple[bool, Dict[str, dict]]:
    """``correct`` and the compared numbers beside their limits."""
    compared = {name: {"value": result[name], "limit": limit}
                for name, limit in limits["at_most"].items()}
    compared["served_tokens"] = {"value": result["tokens"],
                                 "limit": limits["served_tokens_at_least"]}
    ok = result["tokens"] >= limits["served_tokens_at_least"] and all(
        np.isfinite(v["value"]) and v["value"] <= v["limit"]
        for k, v in compared.items() if k != "served_tokens")
    return bool(ok), compared


def finished_requests(run, engine) -> List[Tuple[int, np.ndarray, List[int]]]:
    """``(rid, prompt, served)`` of every request the engine finished."""
    out: List[Tuple[int, np.ndarray, List[int]]] = []
    for rid in run.finished:
        req = engine.requests[rid]
        if req.state == "done":
            out.append((rid, np.asarray(req.prompt),
                        [int(t) for t in req.out_tokens]))
    return out
