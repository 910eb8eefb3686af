"""Per-layer quantities of a traced run, from its profile (``trace``),
its spans and the benchmark's own counts. Each returns None where the
run has nothing to read."""
import statistics

from counts import nets, rigid_body, solve

FP32_PEAK = solve.H100_FP32_FLOPS


def span_mean(ctx, name: str):
    xs = ctx.spans.get(name)
    return statistics.fmean(xs) if xs else None


def launch_calls_per_env_step(ctx):
    p = ctx.profile
    if p is None or not p.kernels or not p.env_steps:
        return None
    return p.launches / p.env_steps


def device_idle_pct(ctx):
    p = ctx.profile
    if p is None or not p.kernels or not p.window_s:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)


def _solve_calls(ctx):
    """(ops, bytes) of each recorded solve call, from its active rows."""
    out = []
    for nv, K, L, iters, k_act, l_act in ctx.profile.solve_rows:
        ops = float(solve.ops_per_env(nv, k_act, l_act, iters).sum())
        out.append((ops, solve.call_bytes(len(k_act), nv, K, L), nv, K, L,
                    iters, k_act, l_act))
    return out


def solve_roofline_pct(ctx):
    """The least time of the solve calls (their active rows' operations,
    their inputs' bytes) over the fused-solve kernels' device time."""
    p = ctx.profile
    if p is None or not p.solve_kernel_s:
        return None
    calls = _solve_calls(ctx)
    if len(calls) != len(p.solve_kernel_s):
        return None
    least = sum(solve.bound_s(ops, byts) for ops, byts, *_ in calls)
    all_slots = sum(solve.bound_s(solve.all_slots_ops(len(k), nv, K, L, it),
                                  byts)
                    for _, byts, nv, K, L, it, k, _ in calls)
    ctx.info["solve_bound_s"] = dict(active=least, all_slots=all_slots,
                                     device=sum(p.solve_kernel_s),
                                     launches=len(calls))
    return 100.0 * least / sum(p.solve_kernel_s)


def mfu_pct(ctx):
    """Counted flops of the profiled window over its length and the
    H100's fp32 peak: the env steps' solve (active rows), CRBA and RNE,
    the policy's forwards and the update's samples. FK, collision, the
    observation, the reward and resets are not counted."""
    p = ctx.profile
    if p is None or not p.kernels or not p.window_s:
        return None
    cfg = ctx.config
    flops = 0.0
    for nv, K, L, iters, k_act, l_act in p.solve_rows:
        flops += rigid_body.env_step_flops(cfg, float(k_act.sum()),
                                           float(l_act.sum()), len(k_act),
                                           iters)
    obs_dim, act_dim = ctx.obs_act
    arch = cfg["net_arch"]
    flops += p.work.get("policy_samples", 0) * nets.actor_critic_flops(
        obs_dim, act_dim, arch)
    flops += p.work.get("train_samples", 0) * nets.train_sample_flops(
        obs_dim, act_dim, arch)
    ctx.info["mfu_flops"] = flops
    return 100.0 * flops / p.window_s / FP32_PEAK


def collective_ms_per_iter(ctx):
    """Device time of the NCCL kernels in rank 0's traced iteration, in
    ms (it holds the wait for the slowest rank)."""
    p = ctx.profile
    if p is None or not p.nccl_kernel_s:
        return None
    return 1e3 * p.nccl_kernel_s
