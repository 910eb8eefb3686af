"""The rank of a data-parallel PPO cell (``drivers/ppo_dp.py``): it runs
``drivers/ppo.py`` on its mesh and returns what rank 0 measured. It
lives here, in a module the spawned ranks import by name."""


def rank_main(mesh, payload: dict):
    from bmk import faults, spec
    from bmk.run import Run

    ctx = Run(**payload["run"])
    ctx.device = str(mesh.device)
    driver = spec.module("drivers", "ppo")
    with faults.fault(payload.get("fault")):
        out = driver.run(ctx, mesh=mesh)
    if mesh.rank:
        return dict(out=out)
    if payload.get("control"):
        out["control"] = driver.check(ctx, ctx.caps, "tf32",
                                      world=mesh.world)
    return dict(out=out, info=ctx.info, spans=ctx.spans,
                profile=ctx.profile, obs_act=ctx.obs_act)
