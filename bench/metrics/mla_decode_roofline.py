"""Latent attention's decode kernels (``csrc/mla_decode.cu``): the least
time the profiled rounds' paged calls need (the architecture file's
``paged_least_s``; for latent attention each row's cached rows read once,
its queries and outputs, the absorbed operations, in every layer;
against the card's peaks), in % of the device time of the kernels whose
names hold ``mla_decode`` in the trace.  None without a trace or without
those kernels."""

from bench.record import architecture, kernel_seconds


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    secs = kernel_seconds(rec, "mla_decode")
    arch, m = architecture(rec), rec["model"]
    mp = -(-rec["engine"]["max_seq_len"] // rec["engine"]["page_tokens"])
    least = sum(arch.paged_least_s(m, ctx, mp)
                for r in tr["rounds"] for ctx in r["contexts"])
    if secs <= 0 or least <= 0:
        return None
    return 100.0 * least / secs
