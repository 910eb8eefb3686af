"""The whole step's share of the H100's fp32 peak, read in the train
cells (see ``bmk.layer.mfu_pct``)."""
from bmk import layer


def read(ctx):
    return layer.mfu_pct(ctx)
