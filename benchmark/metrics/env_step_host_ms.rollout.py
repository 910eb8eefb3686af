"""Median host milliseconds of the program's ``env.step`` spans (one
``step_auto_reset`` each) in the profiled sub-window of a traced run.
The program records its spans (``deepmimic_mujoco_tpu_torch/utils/
tracing.py``) while a torch profiler is active, in memory only, so the
profile itself is left as it was. None where the program records no
such span.

Into the run's info line: ``env_step_self_ms``, for each ``env.*`` and
``engine.*`` stage the median over the window's steps of its self time
in a step (its spans' time less their children's, summed within the
step); ``setup_spans_s``, the seconds of the ``setup.*`` spans, and
``setup_unspanned_s``, ``setup_s`` less their sum."""
import statistics


def recorder():
    """The program's recorder, or None where the program has none."""
    try:
        from deepmimic_mujoco_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def _setup_info(ctx, spans, by_id):
    secs = {}
    for s in spans:
        up = by_id.get(s.parent)
        if s.name.startswith("setup.") and not (
                up is not None and up.name.startswith("setup.")):
            secs[s.name] = (secs.get(s.name, 0.0)
                            + (s.end_ns - s.start_ns) / 1e9)
    ctx.info["setup_spans_s"] = secs
    if "setup_s" in ctx.info:
        ctx.info["setup_unspanned_s"] = ctx.info["setup_s"] - sum(
            secs.values())


def read(ctx):
    tracing = recorder()
    if tracing is None:
        return None
    spans = tracing.snapshot().spans
    by_id = {s.id: s for s in spans}
    steps = {s.id: {} for s in spans if s.name == "env.step"}
    if not steps:
        return None
    covered = {}
    for s in spans:
        if s.parent is not None:
            covered[s.parent] = (covered.get(s.parent, 0)
                                 + s.end_ns - s.start_ns)
    for s in spans:
        if not s.name.startswith(("env.", "engine.")):
            continue
        up = s
        while up is not None and up.id not in steps:
            up = by_id.get(up.parent)
        if up is not None:
            stage = steps[up.id]
            stage[s.name] = (stage.get(s.name, 0) + s.end_ns - s.start_ns
                             - covered.get(s.id, 0))
    names = sorted({n for stage in steps.values() for n in stage})
    ctx.info["env_step_self_ms"] = {
        n: statistics.median(stage.get(n, 0) / 1e6
                             for stage in steps.values()) for n in names}
    _setup_info(ctx, spans, by_id)
    return statistics.median((by_id[i].end_ns - by_id[i].start_ns) / 1e6
                             for i in steps)
