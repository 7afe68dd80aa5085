"""Time the engine's layers from outside, for the traced run.

Each wrapper replaces one of the engine's callables with a function that
synchronises the device, calls it, synchronises again and adds the host
seconds to the current round (as ``chip_smoke.py``'s breakdown does).  The
syncs keep the layers from overlapping, so they cost a little: only the
``--trace 1`` run installs them, and its end-to-end figures are not
reported.  Wrapped:

* ``prefill``: ``engine._prefill_fn`` (the staged prefill: flash kernel and
  the model's prefill), with each prompt's length;
* ``decode_view`` and ``commit_decode``: ``engine.kv``'s, the LMB tier's
  part of a round (``PagedKVStore`` over ``LinkedBuffer`` over
  ``TierExecutor``);
* ``model_step``: ``engine._paged_fn``, the staged paged step, with the
  round's context lengths.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List


class Recorder:
    """Per-round sums of the wrapped layers' seconds, and what they saw."""

    def __init__(self, sync: Callable[[], None],
                 clock: Callable[[], float] = time.monotonic,
                 span: Callable[[str], object] = lambda name:
                 contextlib.nullcontext()):
        self.sync = sync
        self.clock = clock
        #: a host range the device trace labels idle time by
        #: (``torch.profiler.record_function`` on the card)
        self.span = span
        self.current: Dict[str, float] = {}
        self.prefills: List[int] = []          # prompt lengths this round
        self.contexts: List[List[int]] = []    # paged steps' lengths
        self.rounds: List[dict] = []

    def timed(self, name: str, fn: Callable, note=None) -> Callable:
        def run(*args, **kw):
            self.sync()
            t = self.clock()
            with self.span("bench." + name):
                out = fn(*args, **kw)
                self.sync()
            self.current[name] = self.current.get(name, 0.0) \
                + self.clock() - t
            if note is not None:
                note(*args)
            return out
        return run

    def install(self, engine) -> None:
        prefill = engine._prefill_fn
        step = engine.step

        def round_(*args, **kw):
            with self.span("bench.round"):
                return step(*args, **kw)
        engine.step = round_

        engine._prefill_fn = self.timed(
            "prefill", prefill,
            lambda params, toks: self.prefills.append(int(toks.shape[-1])))
        engine.kv.decode_view = self.timed("decode_view",
                                           engine.kv.decode_view)
        engine.kv.commit_decode = self.timed("commit_decode",
                                             engine.kv.commit_decode)
        if engine._paged_fn is not None:
            engine._paged_fn = self.timed(
                "model_step", engine._paged_fn,
                lambda params, pool, tables, lengths, toks:
                    self.contexts.append(
                        [int(n) for n in lengths.tolist()]))

    def end_round(self, phase: str, wall: float) -> None:
        self.rounds.append({"phase": phase, "wall": wall,
                            "layers": self.current,
                            "prefills": self.prefills,
                            "contexts": self.contexts})
        self.current, self.prefills, self.contexts = {}, [], []
