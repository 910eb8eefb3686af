"""``env_step_graph_pct``, read in the train cells: the profiled
iteration's rollout steps (see ``env_step_graph_pct.rollout.py``)."""
from bmk import spec


def read(ctx):
    return spec.module("metrics", "env_step_graph_pct.rollout").read(ctx)
