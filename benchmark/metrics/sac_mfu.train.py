"""The whole SAC iteration's share of the H100's fp32 peak: the counted
flops of the profiled iteration over its length and 67 TFLOP/s (TF32
stays off). Counted: the env steps as ``bmk.layer.mfu_pct`` counts them
(the solve at its active rows, CRBA and RNE), the collect's sampled
actions and the updates' samples (``counts/sac.py``). FK, collision,
the observation, the reward, resets, the losses, Adam and the Polyak
step are not: a lower bound. None where the run profiled no device
kernel or counted no SAC work."""
from bmk import layer
from counts import rigid_body, sac


def read(ctx):
    p = ctx.profile
    if (p is None or not p.kernels or not p.window_s
            or "update_samples" not in p.work):
        return None
    cfg = ctx.config
    flops = 0.0
    for nv, K, L, iters, k_act, l_act in p.solve_rows:
        flops += rigid_body.env_step_flops(cfg, float(k_act.sum()),
                                           float(l_act.sum()), len(k_act),
                                           iters)
    obs_dim, act_dim = ctx.obs_act
    arch = cfg["net_arch"]
    flops += p.work["actor_samples"] * sac.actor_flops(
        obs_dim, act_dim, arch)
    flops += p.work["update_samples"] * sac.update_sample_flops(
        obs_dim, act_dim, arch, cfg["critics"])
    ctx.info["sac_mfu_flops"] = flops
    return 100.0 * flops / p.window_s / layer.FP32_PEAK
