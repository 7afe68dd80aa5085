"""Fault tolerance & straggler mitigation for the training launcher.

At 1000+ nodes, something is always failing.  The runnable pieces here are
host-level (they run identically in the single-process CI environment and
on a real multi-host pod):

  * **HeartbeatMonitor** — per-host liveness with deadline detection; the
    launcher registers hosts and marks them dead on missed beats.
  * **StragglerDetector** — per-step wall-time EWMA + MAD outlier flagging;
    the mitigation hook (re-shard or evict) is the launcher's choice.
  * **restart supervision** — ``run_supervised`` wraps the train loop,
    checkpoints periodically, and on (injected or real) failure restores
    the latest checkpoint and continues — the restart path the tests
    exercise.
  * **elastic re-mesh** — a checkpoint written on mesh A restores onto
    mesh B (``restore_checkpoint(..., shardings=new)``); combined with the
    deterministic data stream, training continues bit-exactly modulo
    reduction order.

LMB tie-in: the FabricManager journal makes pool state reconstructible
after an expander failover; LinkedBuffer consumers degrade to onboard-only
(capacity shed, not death) when no spare exists — see repro_torch.core.fabric.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class HostState:
    host_id: str
    last_beat: float
    alive: bool = True


class HeartbeatMonitor:
    def __init__(self, deadline_s: float = 60.0):
        self.deadline_s = deadline_s
        self._hosts: Dict[str, HostState] = {}

    def register(self, host_id: str) -> None:
        self._hosts[host_id] = HostState(host_id, time.monotonic())

    def beat(self, host_id: str) -> None:
        st = self._hosts.get(host_id)
        if st:
            st.last_beat = time.monotonic()
            st.alive = True

    def check(self, now: Optional[float] = None) -> List[str]:
        """Returns newly-dead hosts."""
        now = now if now is not None else time.monotonic()
        dead = []
        for st in self._hosts.values():
            if st.alive and now - st.last_beat > self.deadline_s:
                st.alive = False
                dead.append(st.host_id)
        return dead

    @property
    def alive_hosts(self) -> List[str]:
        return [h for h, st in self._hosts.items() if st.alive]


class StragglerDetector:
    """Flags steps (or hosts) whose step time is a robust outlier.

    Mitigation at scale: the launcher can exclude the host from the next
    mesh (elastic re-mesh) or lower its data share; flagging is the part
    that must be correct and is what we test.
    """

    def __init__(self, window: int = 64, threshold: float = 3.0):
        self.window = window
        self.threshold = threshold
        self._times: deque = deque(maxlen=window)

    def observe(self, step_time_s: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        flagged = False
        if len(self._times) >= 8:
            med = sorted(self._times)[len(self._times) // 2]
            mad = sorted(abs(t - med) for t in self._times)[
                len(self._times) // 2]
            if step_time_s > med + self.threshold * max(mad, 0.05 * med):
                flagged = True
        self._times.append(step_time_s)
        return flagged


class FailureInjector:
    """Deterministic failure schedule for tests: fail at given steps."""

    def __init__(self, fail_at: Optional[set] = None):
        self.fail_at = fail_at or set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise RuntimeError(f"injected failure at step {step}")


def run_supervised(train_once: Callable[[int], int],
                   max_restarts: int = 3) -> int:
    """Run ``train_once(start_step) -> final_step``, restarting on failure.

    ``train_once`` is responsible for restoring from the latest checkpoint
    when start_step > 0 (the tests drive this with FailureInjector).
    """
    restarts = 0
    start = 0
    while True:
        try:
            return train_once(start)
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
            start = -1  # sentinel: resume from latest checkpoint
