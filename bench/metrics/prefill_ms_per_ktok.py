"""Prefill layer (``serve/staged.py`` ``StagedPrefill`` over
``Model.prefill``, flash kernel): synchronised host milliseconds of the
window's prefills per 1,000 prompt tokens."""

from bench.record import prefill_ms_per_ktok


def read(rec):
    return prefill_ms_per_ktok(rec)
