"""``solve_slot_occupancy_pct``, read in the train cells: the profiled
iteration's solves (see ``solve_slot_occupancy_pct.rollout.py``)."""
from bmk import spec


def read(ctx):
    return spec.module("metrics",
                       "solve_slot_occupancy_pct.rollout").read(ctx)
