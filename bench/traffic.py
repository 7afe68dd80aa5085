"""The one traffic generator: a traffic file's parameters and a seed in,
the run's requests out.

A traffic file (``bench/traffic/<mix>.json``) holds data only:

* ``clients``: the closed loop's clients; each sends its next request the
  instant its last one finished;
* ``requests``: how many requests a run may draw;
* ``prompt`` and ``output``: the distributions of prompt tokens and of new
  tokens per request, each ``{"dist": "uniform", "lo", "hi"}`` over the
  integers ``lo..hi``;
* ``warmup``: ``{"rounds": n}``, the engine's rounds before the window;
* ``why``: who sends such traffic, and where its lengths come from.

Every request's sizes are drawn independently from the seed, repeats and
all, so two seeds differ in the work they hold as two stretches of real
traffic do.  Each client's first request is cut to a residual output
length, drawn from the stationary residual of the output distribution, so
the window opens on clients that are spread over their requests, not on a
cohort that started together.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Planned:
    """One request of a run: its prompt and its new tokens."""

    prompt: np.ndarray
    max_new_tokens: int


def support(dist: dict) -> np.ndarray:
    """The lengths ``lo..hi`` a distribution draws from."""
    if dist["dist"] != "uniform":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.arange(int(dist["lo"]), int(dist["hi"]) + 1)


def draw(dist: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` independent lengths from ``dist``."""
    return rng.choice(support(dist), size=n)


def residual_probabilities(dist: dict) -> np.ndarray:
    """P(R = r), r = 1..hi, of the stationary residual of a renewal
    process whose lifetimes follow ``dist``: proportional to P(L >= r)."""
    lengths = support(dist)
    survive = np.array([(lengths >= r).mean()
                        for r in range(1, int(lengths.max()) + 1)])
    return survive / survive.sum()


def plan(traffic: dict, seed: int, vocab: int) -> List[Planned]:
    """The run's requests, in the order the closed loop hands them out."""
    rng = np.random.default_rng(seed)
    n, clients = int(traffic["requests"]), int(traffic["clients"])
    prompts = draw(traffic["prompt"], n, rng)
    outs = draw(traffic["output"], n, rng)
    res = residual_probabilities(traffic["output"])
    outs[:clients] = rng.choice(np.arange(1, len(res) + 1), size=clients,
                                p=res)
    return [Planned(prompt=rng.integers(0, vocab, int(p)).astype(np.int32),
                    max_new_tokens=int(o)) for p, o in zip(prompts, outs)]
