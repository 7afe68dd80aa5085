"""Paged attention kernel (``csrc/paged_attention.cu``): the least time
the profiled rounds' paged calls need (``bench.counts``: live keys and
values read once, queries, outputs, tables; against the card's peaks), in
% of the device time of its split and combine kernels in the trace."""

from bench import counts
from bench.record import kernel_seconds


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    secs = kernel_seconds(rec, "paged_split_kernel", "paged_combine_kernel")
    m, L = rec["model"], rec["model"]["num_layers"]
    mp = -(-rec["engine"]["max_seq_len"] // rec["engine"]["page_tokens"])
    least = sum(L * counts.least_seconds(
        *counts.paged_attention_call(m, ctx, mp))
        for r in tr["rounds"] for ctx in r["contexts"])
    if secs <= 0 or least <= 0:
        return None
    return 100.0 * least / secs
