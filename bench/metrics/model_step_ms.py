"""Model step (``serve/staged.py`` ``StagedStep`` over
``Model.decode_step_paged``): synchronised host milliseconds per window
round in the staged paged step."""

from bench.record import per_round_ms


def read(rec):
    return per_round_ms(rec, ("model_step",))
