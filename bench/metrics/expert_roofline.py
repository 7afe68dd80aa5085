"""Expert kernels (``kernels/expert_ffn.py``, the held experts' grouped
products): the least time the profiled rounds' prefills (their prompt
lengths) and decode steps (their batch) need in them (the architecture
file's ``expert_least_s``: the expected routed pairs' operations, the
held experts' weights those tokens reach in expectation, in every expert
layer; against the card's peaks), in % of the device time of the kernels
whose names start with ``expert_`` in the trace.  None for an
architecture without the count or a trace without the kernels."""

from bench.record import architecture, kernel_seconds


def read(rec):
    tr = rec["trace"]
    arch = architecture(rec)
    if tr is None or not hasattr(arch, "expert_least_s"):
        return None
    secs = kernel_seconds(rec, "expert_")
    m = rec["model"]
    least = sum(arch.expert_least_s(m, S)
                for r in tr["rounds"] for S in r["prefills"])
    least += sum(arch.expert_least_s(m, len(ctx))
                 for r in tr["rounds"] for ctx in r["contexts"])
    if secs <= 0 or least <= 0:
        return None
    return 100.0 * least / secs
