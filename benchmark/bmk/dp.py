"""The rank of a data-parallel PPO cell (``drivers/ppo_dp.py``): it runs
``drivers/ppo.py`` on its mesh and returns what rank 0 measured. It
lives here, in a module the spawned ranks import by name."""
import os
import resource


def _cpu_jiffies():
    """The machine's CPU time so far (``/proc/stat``): (all, idle with
    iowait, steal) in jiffies, or None where it cannot be read."""
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None
    return sum(v[:8]), v[3] + v[4], v[7]


def _host(before, after, r0, r1):
    """What a rank's host did over its run: its CPU seconds, its context
    switches, and the machine's busy and stolen shares of CPU time."""
    out = dict(cpu_s=(r1.ru_utime + r1.ru_stime) - (r0.ru_utime
                                                   + r0.ru_stime),
               voluntary_switches=r1.ru_nvcsw - r0.ru_nvcsw,
               involuntary_switches=r1.ru_nivcsw - r0.ru_nivcsw)
    if before is not None and after is not None:
        total = after[0] - before[0]
        if total > 0:
            out["machine_busy_pct"] = 100.0 * (
                1 - (after[1] - before[1]) / total)
            out["machine_steal_pct"] = 100.0 * (after[2] - before[2]) / total
    return out


def threads(world: int) -> int:
    """Intra-op threads a rank keeps on the card: the process's cores
    split among the ranks, so that the ranks' pools do not outnumber the
    cores (on the CPU ``dryrun.launch`` keeps one)."""
    return max(1, len(os.sched_getaffinity(0)) // world)


def records(tracing):
    """The program's spans and counters so far, with every counter's
    tensor values summed on the host, so that they travel as numbers."""
    snap = tracing.snapshot()
    return snap._replace(counters={k: (calls, snap.total(k), [])
                                   for k, (calls, _, _) in
                                   snap.counters.items()})


def load(tracing, snap):
    """Make ``snap`` (rank 0's ``records``) this process's record of
    the program's spans and counters, for the metric readers."""
    tracing.reset()
    tracing._spans.extend(snap.spans)
    for name, (calls, total, _) in snap.counters.items():
        c = tracing._counters[name] = tracing._Counter()
        c.calls, c.folded = calls, total


def rank_main(mesh, payload: dict):
    import torch

    from bmk import faults, spec
    from bmk.run import Run
    from deepmimic_mujoco_tpu_torch.utils import tracing

    if torch.device(mesh.device).type == "cuda":
        torch.set_num_threads(threads(mesh.world))
    ctx = Run(**payload["run"])
    ctx.device = str(mesh.device)
    driver = spec.module("drivers", "ppo")
    r0, j0 = resource.getrusage(resource.RUSAGE_SELF), _cpu_jiffies()
    with faults.fault(payload.get("fault")):
        out = driver.run(ctx, mesh=mesh)
    host = dict(_host(j0, _cpu_jiffies(), r0,
                      resource.getrusage(resource.RUSAGE_SELF)),
                threads=torch.get_num_threads())
    if mesh.rank:
        return dict(out=out, host=host)
    if payload.get("control"):
        out["control"] = driver.check(ctx, ctx.caps, "tf32",
                                      world=mesh.world)
    return dict(out=out, host=host, info=ctx.info, spans=ctx.spans,
                profile=ctx.profile, obs_act=ctx.obs_act,
                records=records(tracing) if ctx.trace else None)
