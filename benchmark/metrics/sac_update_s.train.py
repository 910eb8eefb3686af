"""Seconds of ``SAC.update`` (the iteration's gradient updates) per
iteration in the window of a traced run (a span synchronised at both
ends), the mean."""
from bmk import layer


def read(ctx):
    return layer.span_mean(ctx, "sac_update_s")
