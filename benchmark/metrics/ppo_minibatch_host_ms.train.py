"""Median host milliseconds of the program's ``ppo.minibatch`` spans
(one ``PPO.minibatch_step`` each: the loss, its backward, the gradient
clip and the Adam step) in the profiled iteration of a traced run. None
where the program records no such span (see
``env_step_host_ms.rollout.py`` for where the spans come from).

Into the run's info line (``ppo_spans``): the host seconds of the
iteration's ``ppo.*`` spans by name (``ppo.iter``, ``ppo.rollout`` with
``ppo.policy`` and ``ppo.handoff``, ``ppo.gae``, ``ppo.update``), the
number of minibatch steps, and the count and milliseconds of the
``ppo.host_read`` spans (the KL guard's and the lr controller's reads
of the device)."""
import statistics

from bmk import spec


def read(ctx):
    tracing = spec.module("metrics", "env_step_host_ms.rollout").recorder()
    if tracing is None:
        return None
    spans = tracing.snapshot().spans
    steps = [(s.end_ns - s.start_ns) / 1e6 for s in spans
             if s.name == "ppo.minibatch"]
    if not steps:
        return None
    ns = {}
    for s in spans:
        ns[s.name] = ns.get(s.name, 0) + s.end_ns - s.start_ns
    ctx.info["ppo_spans"] = dict(
        seconds={k: v / 1e9 for k, v in sorted(ns.items())
                 if k.startswith("ppo.")},
        minibatch_steps=len(steps),
        host_reads=sum(s.name == "ppo.host_read" for s in spans),
        host_read_ms=ns.get("ppo.host_read", 0) / 1e6)
    return statistics.median(steps)
