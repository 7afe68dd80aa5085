"""MoE layer (``models/moe.routed_apply``): device milliseconds a profiled
round spends in the expert kernels (names starting with ``expert_``,
``kernels/expert_ffn.py``), prefills and decode steps together.  None
without a trace or without the kernels."""

from bench.record import kernel_seconds


def read(rec):
    tr = rec["trace"]
    if tr is None or not tr["rounds"]:
        return None
    secs = kernel_seconds(rec, "expert_")
    if secs <= 0:
        return None
    return 1e3 * secs / len(tr["rounds"])
