"""The fused solve's share of its roofline, read in the train cells
(see ``bmk.layer.solve_roofline_pct``)."""
from bmk import layer


def read(ctx):
    return layer.solve_roofline_pct(ctx)
