"""Flash attention kernel (``csrc/flash_attention.cu``, prefill): the least
time the profiled rounds' prefills need in it (``bench.counts``: causal
operations, q, k, v and the output once), in % of the device time of its
kernel in the trace."""

from bench import counts
from bench.record import kernel_seconds


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    secs = kernel_seconds(rec, "flash_attention_bf16_kernel")
    m, L = rec["model"], rec["model"]["num_layers"]
    least = sum(L * counts.least_seconds(*counts.flash_attention_call(m, S))
                for r in tr["rounds"] for S in r["prefills"])
    if secs <= 0 or least <= 0:
        return None
    return 100.0 * least / secs
