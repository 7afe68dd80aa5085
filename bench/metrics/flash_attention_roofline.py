"""Flash attention kernel (``csrc/flash_attention.cu``, prefill): the least
time the profiled rounds' prefills need in it (the architecture file's
``flash_least_s``; for dense decoders causal operations, q, k, v and the
output once, in every layer), in % of the device time of its kernel in
the trace."""

from bench.record import architecture, kernel_seconds


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    secs = kernel_seconds(rec, "flash_attention_bf16_kernel")
    arch, m = architecture(rec), rec["model"]
    least = sum(arch.flash_least_s(m, S)
                for r in tr["rounds"] for S in r["prefills"])
    if secs <= 0 or least <= 0:
        return None
    return 100.0 * least / secs
