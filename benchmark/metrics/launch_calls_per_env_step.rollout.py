"""``launch_calls_per_env_step``, read in the rollout cells (see ``bmk.layer``)."""
from bmk import layer


def read(ctx):
    return layer.launch_calls_per_env_step(ctx)
