"""``env_step_host_ms``, read in the train cells: the profiled
iteration's rollout steps (see ``env_step_host_ms.rollout.py``)."""
from bmk import spec


def read(ctx):
    return spec.module("metrics", "env_step_host_ms.rollout").read(ctx)
