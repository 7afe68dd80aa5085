"""fio-like workload generation (paper §4: libaio, QD=64, 4 KB IOs).

Generates deterministic, seeded IO streams over a device's LBA space.
Patterns: ``randread / randwrite / seqread / seqwrite`` (the paper's four),
plus ``zipfread`` for the §4.1.2 locality sweep (hot L2P entries hitting the
onboard cache).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence

import numpy as np

IO_BYTES = 4096
QUEUE_DEPTH = 64


@dataclasses.dataclass(frozen=True)
class IO:
    op: str          # "read" | "write"
    lba: int         # in 4K pages
    nbytes: int = IO_BYTES


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    pattern: str     # "rand" | "seq" | "zipf"
    op: str          # "read" | "write"
    n_ios: int
    queue_depth: int = QUEUE_DEPTH
    io_bytes: int = IO_BYTES
    zipf_alpha: float = 1.2
    seed: int = 0

    def generate(self, lba_space: int) -> np.ndarray:
        """Return LBA array of length n_ios (deterministic)."""
        rng = np.random.default_rng(self.seed)
        if self.pattern == "seq":
            start = int(rng.integers(0, max(lba_space - self.n_ios, 1)))
            return (start + np.arange(self.n_ios)) % lba_space
        if self.pattern == "rand":
            return rng.integers(0, lba_space, self.n_ios)
        if self.pattern == "zipf":
            # bounded zipf over the LBA space
            ranks = rng.zipf(self.zipf_alpha, self.n_ios)
            return (ranks - 1) % lba_space
        raise ValueError(f"unknown pattern {self.pattern}")

    def ios(self, lba_space: int) -> Iterator[IO]:
        for lba in self.generate(lba_space):
            yield IO(self.op, int(lba), self.io_bytes)


def make_workload(name: str, n_ios: int = 200_000, seed: int = 0,
                  **kw) -> Workload:
    """The paper's four workloads by name (+ zipfread)."""
    table = {
        "seqwrite": ("seq", "write"),
        "randwrite": ("rand", "write"),
        "seqread": ("seq", "read"),
        "randread": ("rand", "read"),
        "zipfread": ("zipf", "read"),
    }
    pattern, op = table[name]
    return Workload(name=name, pattern=pattern, op=op, n_ios=n_ios,
                    seed=seed, **kw)


ALL_PAPER_WORKLOADS: List[str] = ["seqwrite", "randwrite", "seqread",
                                  "randread"]


# ---------------------------------------------------------------------------
# Locality (index hit/miss) streams
# ---------------------------------------------------------------------------

def locality_hits(n: int, hit_ratio: float, seed: int) -> np.ndarray:
    """The onboard-index hit stream the DES consumes: ``n`` seeded
    Bernoulli(``hit_ratio``) draws.  ``hit_ratio == 0`` returns the
    all-miss stream WITHOUT touching the RNG (the seed engine's exact
    behaviour, kept so seeded runs stay bit-identical).  Single source
    of truth for both the scalar per-IO engine and the vectorized
    batch path — determinism across the two is tested."""
    if hit_ratio > 0:
        return np.random.default_rng(seed).random(n) < hit_ratio
    return np.zeros(n, dtype=bool)


def batch_locality_hits(n: int, hit_ratio: float,
                        seeds: Sequence[int]) -> np.ndarray:
    """Vectorized batch generation: one ``(len(seeds), n)`` hit matrix,
    row ``i`` identical to ``locality_hits(n, hit_ratio, seeds[i])`` —
    each lane keeps its own seeded stream so a vectorized rack run
    reproduces the scalar per-device runs lane-for-lane."""
    if hit_ratio > 0:
        return np.stack([np.random.default_rng(s).random(n) < hit_ratio
                         for s in seeds])
    return np.zeros((len(seeds), n), dtype=bool)


# ---------------------------------------------------------------------------
# Arrival processes (serving load generation)
# ---------------------------------------------------------------------------
#: arrival processes ``arrival_times`` understands
ARRIVAL_PROCESSES = ("poisson", "bursty")


def arrival_times(n: int, rate_rps: float, *, process: str = "poisson",
                  burst_size: int = 8, burst_factor: float = 10.0,
                  seed: int = 0, t0: float = 0.0) -> np.ndarray:
    """``n`` seeded request arrival timestamps at mean rate ``rate_rps``.

    ``"poisson"`` draws i.i.d. exponential inter-arrival gaps (the
    open-loop serving default).  ``"bursty"`` is an on/off
    (Markov-modulated) process: geometric bursts of mean ``burst_size``
    arrivals whose within-burst rate is ``burst_factor`` times the mean
    rate, separated by compensating idle gaps so the LONG-RUN rate still
    averages ``rate_rps`` — the same offered load, concentrated into
    spikes that stress admission and link queues.  Deterministic for a
    given seed; timestamps are non-decreasing and start at or after
    ``t0``.
    """
    if n < 1:
        return np.empty(0, np.float64)
    if rate_rps <= 0:
        raise ValueError("rate_rps must be > 0")
    if process not in ARRIVAL_PROCESSES:
        raise ValueError(f"unknown arrival process {process!r} "
                         f"(choose from {ARRIVAL_PROCESSES})")
    rng = np.random.default_rng(seed)
    mean_gap = 1.0 / rate_rps
    if process == "poisson":
        gaps = rng.exponential(mean_gap, n)
        return t0 + np.cumsum(gaps)
    if burst_size < 1 or burst_factor <= 1.0:
        raise ValueError("bursty needs burst_size >= 1, burst_factor > 1")
    gaps = np.empty(n, np.float64)
    fast_gap = mean_gap / burst_factor
    done = 0
    while done < n:
        burst = min(int(rng.geometric(1.0 / burst_size)), n - done)
        gaps[done:done + burst] = rng.exponential(fast_gap, burst)
        done += burst
        if done < n:
            # idle long enough that the burst+idle cycle averages out to
            # the requested mean rate: burst arrivals "owe" the slow
            # process (mean_gap - fast_gap) each
            owed = burst * (mean_gap - fast_gap)
            gaps[done - 1] += rng.exponential(owed) if owed > 0 else 0.0
    return t0 + np.cumsum(gaps)


def batch_arrival_times(n: int, rate_rps: float, seeds: Sequence[int],
                        **kw) -> np.ndarray:
    """Batched arrival generation: ``(len(seeds), n)`` timestamp matrix,
    row ``i`` identical to ``arrival_times(n, rate_rps, seed=seeds[i],
    **kw)``.  Per-lane seeded streams, so the vectorized rack DES and
    any scalar replay of one lane see the same arrivals."""
    kw.pop("seed", None)
    return np.stack([arrival_times(n, rate_rps, seed=int(s), **kw)
                     for s in seeds])
