"""Data-parallel PPO: ``drivers/ppo.py``'s job with its train state
placed on a process group, one rank a card over NCCL
(``parallel/dryrun.py:launch``, ``parallel/mesh.py:shard_train_state``).
The traffic's sizes are global: each rank steps ``n_envs / world`` envs
and takes ``minibatch_size / world`` rows of each minibatch.

Rank 0's clock decides the window for every rank and gives the global
rate (all ranks' env steps over its wall time, read per layer); rank 0
keeps the captures, checks them (its envs, its share of each
minibatch's loss, the update it applies, which every rank applies
alike) and, traced, profiles one iteration, whose spans and counters
the readers get. ``memory_peak_bytes`` and ``train_memory_peak_gb`` are
the fullest card's. Each rank keeps its share of the cores for its
intra-op threads; the info line has what each rank's host did
(``rank_host``: CPU seconds, context switches, the machine's busy and
stolen CPU shares over the rank's run, threads)."""
import dataclasses

FAULTS = ("no_exchange", "half_batch", "skipped_update", "altered_reward")


def run(ctx):
    from bmk import dp
    from deepmimic_mujoco_tpu_torch.parallel import dryrun
    from deepmimic_mujoco_tpu_torch.utils import tracing

    world = ctx.traffic["world"]
    payload = dict(run={f.name: getattr(ctx, f.name)
                        for f in dataclasses.fields(ctx)},
                   fault=ctx.info.get("fault"),
                   control=ctx.info.get("control"))
    results = dryrun.launch(dp.rank_main, world, args=(payload,),
                            device=ctx.device)
    lead = results[0]
    ctx.info.update(lead["info"])
    ctx.spans.update(lead["spans"])
    ctx.profile, ctx.obs_act = lead["profile"], lead["obs_act"]
    ctx.info["rank_host"] = [r["host"] for r in results]
    if lead["records"] is not None:
        dp.load(tracing, lead["records"])
    out = lead["out"]
    out["memory_peak_bytes"] = max(r["out"]["memory_peak_bytes"]
                                   for r in results)
    out["metrics"]["train_memory_peak_gb"] = out["memory_peak_bytes"] / 1e9
    return out
