"""The whole step: the operations the window's prefill and decode tokens
need (``bench.counts``: two per weight a token multiplies through, causal
attention over the attended positions, the readout), in % of the window's
seconds at the card's bf16 peak."""

from bench import counts
from bench.record import window_rounds


def read(rec):
    m = rec["model"]
    flops = 0.0
    for r in window_rounds(rec):
        flops += sum(counts.prefill_flops(m, S) for S in r["prefills"])
        flops += sum(counts.decode_flops(m, n)
                     for ctx in r["contexts"] for n in ctx)
    if flops <= 0 or rec["window_s"] <= 0:
        return None
    return 100.0 * flops / (rec["window_s"] * counts.PEAK_BF16_FLOPS)
