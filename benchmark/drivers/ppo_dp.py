"""Data-parallel PPO: ``drivers/ppo.py``'s job with its train state
placed on a process group, one rank a card over NCCL
(``parallel/dryrun.py:launch``, ``parallel/mesh.py:shard_train_state``).
The traffic's sizes are global: each rank steps ``n_envs / world`` envs
and takes ``minibatch_size / world`` rows of each minibatch.

Rank 0's clock decides the window for every rank and gives the global
rate (all ranks' env steps over its wall time); rank 0 keeps the
captures, checks them (its envs, its share of each minibatch's loss,
the update it applies, which every rank applies alike) and, traced,
profiles one iteration. ``memory_peak_bytes`` is the fullest card's."""
import dataclasses


def run(ctx):
    from bmk import dp
    from deepmimic_mujoco_tpu_torch.parallel import dryrun

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
    out = lead["out"]
    out["memory_peak_bytes"] = max(r["out"]["memory_peak_bytes"]
                                   for r in results)
    return out
