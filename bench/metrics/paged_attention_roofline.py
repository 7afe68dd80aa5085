"""Paged attention kernel (``csrc/paged_attention.cu``): the least time
the profiled rounds' paged calls need (the architecture file's
``paged_least_s``; for dense decoders live keys and values read once,
queries, outputs, tables, in every layer; against the card's peaks), in %
of the device time of its split and combine kernels in the trace."""

from bench.record import architecture, kernel_seconds


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    secs = kernel_seconds(rec, "paged_split_kernel", "paged_combine_kernel")
    arch, m = architecture(rec), rec["model"]
    mp = -(-rec["engine"]["max_seq_len"] // rec["engine"]["page_tokens"])
    least = sum(arch.paged_least_s(m, ctx, mp)
                for r in tr["rounds"] for ctx in r["contexts"])
    if secs <= 0 or least <= 0:
        return None
    return 100.0 * least / secs
