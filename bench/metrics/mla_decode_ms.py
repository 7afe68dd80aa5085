"""Latent attention (``models/mla.py`` over ``kernels/mla_decode.py``):
device milliseconds a profiled round spends in the kernels whose names
hold ``mla_decode``.  None without a trace or without those kernels."""

from bench.record import kernel_seconds


def read(rec):
    tr = rec["trace"]
    if tr is None or not tr["rounds"]:
        return None
    secs = kernel_seconds(rec, "mla_decode")
    if secs <= 0:
        return None
    return 1e3 * secs / len(tr["rounds"])
