"""Seconds of ``SAC.collect`` (the iteration's env steps under the
sampled actor, written into the replay buffer) per iteration in the
window of a traced run (a span synchronised at both ends), the mean."""
from bmk import layer


def read(ctx):
    return layer.span_mean(ctx, "sac_collect_s")
