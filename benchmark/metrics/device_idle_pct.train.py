"""``device_idle_pct``, read in the train cells (see ``bmk.layer``)."""
from bmk import layer


def read(ctx):
    return layer.device_idle_pct(ctx)
