"""Engine layer (``serve/engine.py``): milliseconds of a window round
outside the wrapped prefill, LMB tier and model step (admission,
scheduling, bookkeeping, the round's host sync)."""

from bench.record import window_rounds


def read(rec):
    rounds = window_rounds(rec)
    if not rounds:
        return None
    other = sum(r["wall"] - sum(r["layers"].values()) for r in rounds)
    return 1e3 * other / len(rounds)
