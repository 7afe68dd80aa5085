"""What the per-layer readers (``bench/metrics/<name>.py``) share.

A traced run hands each reader one record (``bench.run.execute``):

* ``rounds``: every step the driver made once the layers were wrapped,
  each ``{"phase", "wall", "layers": {layer: seconds}, "prefills": [prompt
  lengths], "contexts": [[stored tokens per row] per paged step]}``;
  ``phase`` is ``"window"`` for the measured seconds and ``"after"`` for
  the rounds profiled after them;
* ``window_s`` and ``tokens``, the window's seconds and output tokens;
* ``trace``: ``None``, or the profiled rounds' ``busy_s``, ``window_s``,
  device seconds per kernel name (``kernels``) and those rounds;
* ``model`` and ``engine``: the configuration's sections;
* ``reference``: the path of the configuration's architecture file, whose
  counts the count-based readers take (``architecture``).

A reader returns ``None`` where it finds nothing to read.
"""

from __future__ import annotations

from types import ModuleType
from typing import List, Optional

from bench import manifest

LMB_LAYERS = ("decode_view", "commit_decode")


def architecture(rec: dict) -> ModuleType:
    """The run's architecture file (``bench/reference/__init__.py``)."""
    return manifest.architecture(rec["reference"])


def window_rounds(rec: dict) -> List[dict]:
    return [r for r in rec["rounds"] if r["phase"] == "window"]


def per_round_ms(rec: dict, layers) -> Optional[float]:
    """Mean milliseconds a window round spent in ``layers``."""
    rounds = window_rounds(rec)
    if not rounds:
        return None
    total = sum(r["layers"].get(n, 0.0) for r in rounds for n in layers)
    return 1e3 * total / len(rounds)


def prefill_ms_per_ktok(rec: dict) -> Optional[float]:
    """Milliseconds of the window's prefills per 1,000 prompt tokens."""
    rounds = window_rounds(rec)
    toks = sum(sum(r["prefills"]) for r in rounds)
    if not toks:
        return None
    secs = sum(r["layers"].get("prefill", 0.0) for r in rounds)
    return 1e3 * secs / (toks / 1e3)


def kernel_seconds(rec: dict, *names: str) -> float:
    """Device seconds of the traced kernels whose names hold any of
    ``names``."""
    return sum(s for k, s in rec["trace"]["kernels"].items()
               if any(n in k for n in names))
