"""The share of the fused solve's contact slots that hold an active
contact, over the solve calls of the profiled sub-window of a traced
run: 100 x the program's ``solve.active_slots`` over its
``solve.slots`` counters (counted at the solve's call in
``physics/solver.py``, summed when read). It bounds what skipping the
inactive slots could save. None where the program counts no solve.

Into the run's info line (``solve_slots``): the active share of the
joint-limit rows, the solve calls counted, and the window's solve
launches as the profile saw them (``window_launches``, the fused-solve
kernels on the card) and as the benchmark recorded them
(``recorded_calls``): the three counts agree."""
from bmk import spec


def read(ctx):
    tracing = spec.module("metrics", "env_step_host_ms.rollout").recorder()
    if tracing is None:
        return None
    snap = tracing.snapshot()
    calls = snap.calls("solve.slots")
    if not calls:
        return None
    slots = snap.total("solve.slots")
    limit_rows = snap.total("solve.limit_rows")
    prof = ctx.profile
    recorded = getattr(prof, "solve_rows", None)
    ctx.info["solve_slots"] = dict(
        calls=calls, slots=slots,
        active_slots=snap.total("solve.active_slots"),
        limit_rows_active_pct=(100.0 * snap.total("solve.active_limit_rows")
                               / limit_rows if limit_rows else None),
        window_launches=len(prof.solve_kernel_s)
        if prof is not None and prof.solve_kernel_s else None,
        recorded_calls=None if recorded is None else len(recorded))
    return 100.0 * ctx.info["solve_slots"]["active_slots"] / slots
