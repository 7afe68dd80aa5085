"""The whole step: the operations the window's prefill and decode tokens
need (the architecture file's ``prefill_flops`` and ``decode_flops``; for
dense decoders two per weight a token multiplies through, causal attention
over the attended positions, the readout), in % of the window's seconds at
the card's bf16 peak (``bench.counts``)."""

from bench import counts
from bench.record import architecture, window_rounds


def read(rec):
    arch, m = architecture(rec), rec["model"]
    flops = 0.0
    for r in window_rounds(rec):
        flops += sum(arch.prefill_flops(m, S) for S in r["prefills"])
        flops += sum(arch.decode_flops(m, n)
                     for ctx in r["contexts"] for n in ctx)
    if flops <= 0 or rec["window_s"] <= 0:
        return None
    return 100.0 * flops / (rec["window_s"] * counts.PEAK_BF16_FLOPS)
