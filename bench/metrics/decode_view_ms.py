"""LMB tier (``serve/kv_cache.py`` over ``core/buffer.py`` over
``core/offload.py``): synchronised host milliseconds per window round in
``PagedKVStore.decode_view`` and ``commit_decode``."""

from bench.record import LMB_LAYERS, per_round_ms


def read(rec):
    return per_round_ms(rec, LMB_LAYERS)
