"""The share of the profiled sub-window's env steps that the program
served by replaying the step's CUDA graphs
(``deepmimic_mujoco_tpu_torch/envs/graphs.py``) rather than op by op:
100 x its ``env.graph_replays`` counter over its ``env.step`` spans. The
program counts a replay or an eager run (``env.graph_eager``) at every
step while a torch profiler is active. None where it counts neither."""
from bmk import spec


def read(ctx):
    tracing = spec.module("metrics", "env_step_host_ms.rollout").recorder()
    if tracing is None:
        return None
    snap = tracing.snapshot()
    if not (snap.calls("env.graph_replays") or snap.calls("env.graph_eager")):
        return None
    steps = sum(s.name == "env.step" for s in snap.spans)
    if not steps:
        return None
    return 100.0 * snap.total("env.graph_replays") / steps
