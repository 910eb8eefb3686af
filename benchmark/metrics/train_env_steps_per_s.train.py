"""All env steps of the window's whole iterations (every rank's envs)
over its wall time, host clock between ``synchronize`` calls, in a
traced run: the training rate, read per layer since its runs on a
shared host spread wider than any bound the benchmark may set."""


def read(ctx):
    steps = ctx.info.get("window_env_steps")
    wall = ctx.info.get("window_s")
    return steps / wall if steps and wall else None
