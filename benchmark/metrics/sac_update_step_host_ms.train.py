"""Median host milliseconds of the program's ``sac.update_step`` spans
(one SAC update each: the Q target, the critic, actor and temperature
steps and the Polyak step) in the profiled iteration of a traced run.
None where the program records no such span (see
``env_step_host_ms.rollout.py`` for where the spans come from).

Into the run's info line (``sac_spans``): the host seconds of the
iteration's ``sac.*`` spans by name (``sac.iter``, ``sac.collect`` with
``sac.policy`` and ``sac.buffer_write``, ``sac.update``,
``sac.update_step``), the updates counted (``sac.updates``) and the
mean of the valid buffer rows each drew from (``sac.buffer_rows``)."""
import statistics

from bmk import spec


def read(ctx):
    tracing = spec.module("metrics", "env_step_host_ms.rollout").recorder()
    if tracing is None:
        return None
    snap = tracing.snapshot()
    steps = [(s.end_ns - s.start_ns) / 1e6 for s in snap.spans
             if s.name == "sac.update_step"]
    if not steps:
        return None
    secs = tracing.seconds_by_name(
        [s for s in snap.spans if s.name.startswith("sac.")])
    draws = snap.calls("sac.buffer_rows")
    ctx.info["sac_spans"] = dict(
        seconds=dict(sorted(secs.items())), updates=snap.total("sac.updates"),
        buffer_rows=snap.total("sac.buffer_rows") / draws if draws else None)
    return statistics.median(steps)
