"""Drive a ``ServeEngine`` with a run's planned requests and stamp what it
serves.

The driver is the engine's only caller: it submits each request
(``SubmitSpec``), calls ``step()`` and, when a step returns, stamps every
token that step produced with the host clock.  The loop is closed: each
client sends the next request of the run's order the instant its last one
finished.  A run has three phases at step boundaries: ``warm`` (the mix's
own traffic until the window opens), ``window`` (the measured seconds),
and ``after`` (further rounds of the same traffic, which a traced run
profiles).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from bench.tails import Stamped
from bench.traffic import Planned

DONE = ("done", "cancelled", "shed")


@dataclasses.dataclass
class Run:
    start: float
    end: float
    stamped: Dict[int, Stamped]
    planned: Dict[int, Planned]
    #: wall seconds of each step that returned inside the window
    round_walls: List[float]
    #: requests finished by the time the driver stopped
    finished: List[int]


def serve(engine, traffic: dict, planned: List[Planned], seconds: float, *,
          done_after: Callable[[int], bool] = lambda n: True,
          clock: Callable[[], float] = time.monotonic,
          on_round: Optional[Callable[[str, float, float], None]] = None,
          on_phase: Optional[Callable[[str], None]] = None) -> Run:
    """Run the mix: warm-up, then a window of ``seconds``, then further
    steps until ``done_after(steps after the window)`` holds;
    ``on_round(phase, t_before, t_after)`` is called after every step,
    ``on_phase(phase)`` when a phase begins."""
    from repro_torch.serve import SubmitSpec
    stamped: Dict[int, Stamped] = {}
    by_rid: Dict[int, Planned] = {}
    live: Dict[int, object] = {}
    finished: List[int] = []
    walls: List[float] = []

    def submit(p: Planned, due: float) -> None:
        rid = engine.submit(SubmitSpec(prompt=p.prompt,
                                       max_new_tokens=p.max_new_tokens,
                                       arrival_time_s=due))
        stamped[rid] = Stamped(due=due)
        by_rid[rid] = p
        live[rid] = engine.requests[rid]

    def stamp(t: float) -> List[int]:
        done = []
        for rid, req in list(live.items()):
            s = stamped[rid]
            n = len(req.out_tokens)
            if n > len(s.tokens):
                s.tokens.extend([t] * (n - len(s.tokens)))
            if req.state in DONE:
                s.failed = req.state != "done"
                del live[rid]
                done.append(rid)
        finished.extend(done)
        return done

    nxt = int(traffic["clients"])
    t0 = clock()
    for p in planned[:nxt]:
        submit(p, t0)
    warm_rounds = int(traffic["warmup"]["rounds"])
    phase, steps, start, end, extra = "warm", 0, None, None, 0

    def boundary(t: float) -> None:
        nonlocal phase, start, end
        if phase == "warm" and steps >= warm_rounds:
            phase, start = "window", t
        elif phase == "window" and t >= start + seconds:
            phase, end = "after", t
        else:
            return
        if on_phase is not None:
            on_phase(phase)

    while True:
        t_before = clock()
        engine.step()
        t = clock()
        steps += 1
        for _ in stamp(t):
            if nxt >= len(planned):
                raise RuntimeError("the mix's requests ran out: raise "
                                   "'requests' in the traffic file")
            submit(planned[nxt], clock())
            nxt += 1
        current = phase
        if current == "window":
            walls.append(t - t_before)
        elif current == "after":
            extra += 1
        if on_round is not None:
            on_round(current, t_before, t)
        boundary(t)
        if phase == "after" and done_after(extra):
            break
    return Run(start=start, end=end, stamped=stamped, planned=by_rid,
               round_walls=walls, finished=finished)
