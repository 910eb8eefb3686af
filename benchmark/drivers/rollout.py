"""Batched rollout: a ``DPEnv`` of the configuration's robot stepped
with ``step_auto_reset`` under a sampling ``ActorCritic`` made from the
seed, as ``PPO.rollout`` samples it: one policy forward, Gaussian noise
from a generator on the card, the env step.

End-to-end: ``rollout_env_steps_per_s`` (all env steps of the window
over its wall time, synchronised at both ends) and
``rollout_step_ms_p95`` (the 95th percentile of the gaps between CUDA
events recorded after consecutive steps). ``setup_s`` runs from process
start to the first timed step. The check compares the env steps and the
policy samples of ``check_steps`` steps drawn from the seed among the
window's first ``check_from``; ``--trace 1`` profiles ``trace_steps``
steps after the window."""
import time

from bmk import capture, card, clock, trace
from bmk.run import percentile

FAULTS = ("unchanged_state", "half_envs", "altered_reward")


def run(ctx):
    import torch

    from deepmimic_mujoco_tpu_torch.envs import DPEnv
    from deepmimic_mujoco_tpu_torch.ops.fused_solve import fused_solve
    from deepmimic_mujoco_tpu_torch.rl import networks

    tr, cfg = ctx.traffic, ctx.config
    dev = torch.device(ctx.device)
    B = ctx.size("n_envs")
    K = tr.get("max_contacts", cfg["max_contacts"])
    env = DPEnv(motion=tr["motion"], robot=cfg["robot"], max_contacts=K,
                device=dev)
    ctx.check_model(env.engine)
    hp = tr["policy"]
    net = networks.make_policy(
        "torque", env, net_arch=cfg["net_arch"],
        init_log_std=hp["init_log_std"], log_std_min=hp["log_std_min"],
        log_std_max=hp["log_std_max"], device="cpu",
        generator=torch.Generator().manual_seed(ctx.seed)).to(dev)
    g_rsi = torch.Generator(device=dev).manual_seed(ctx.seed * 4 + 3)
    g_act = torch.Generator(device=dev).manual_seed(ctx.seed * 4 + 1)

    def step(states, obs):
        mean, log_std, _ = net(obs)
        noise = torch.randn(mean.shape, generator=g_act, dtype=mean.dtype,
                            device=dev)
        action = mean + torch.exp(log_std) * noise
        states, out = env.step_auto_reset(states, action, g_rsi)
        return states, out, noise, action

    picks = capture.sample_steps(ctx.seed, ctx.size("check_from"),
                                 ctx.size("check_steps"))
    caps = []
    with torch.no_grad():
        states, obs = env.reset(B, generator=g_rsi)
        for _ in range(ctx.size("warmup_steps")):
            states, out, _, _ = step(states, obs)
            obs = out.obs
        card.sync(dev)
        setup_s = time.time() - ctx.t0
        launches0 = dict(fused_solve.launches_by_plan)
        clk = clock.StepClock(dev)
        clk.mark()
        t_start = time.perf_counter()
        n = 0
        overflow = []
        while True:
            pre = capture.clone(states) if n in picks else None
            obs_in = obs
            states, out, noise, action = step(states, obs)
            if pre is not None:
                caps.append(dict(
                    pre=pre, obs_in=capture.clone(obs_in),
                    noise=capture.clone(noise),
                    action=capture.clone(action),
                    obs=capture.clone(out.obs),
                    reward=capture.clone(out.reward),
                    done=capture.clone(out.done),
                    post=capture.clone(states)))
                overflow.append(out.contact_overflow.max())
            obs = out.obs
            clk.mark()
            n += 1
            if (time.perf_counter() - t_start >= ctx.seconds
                    and n > max(picks)):
                break
        card.sync(dev)
        wall = time.perf_counter() - t_start
        plans = {k: v - launches0.get(k, 0)
                 for k, v in fused_solve.launches_by_plan.items()}
        if ctx.trace:
            prof = ctx.profile = trace.Profile()
            with trace.profiled(dev, prof):
                for _ in range(ctx.size("trace_steps")):
                    states, out, _, _ = step(states, obs)
                    obs = out.obs
            prof.env_steps = ctx.size("trace_steps")
            prof.work = dict(policy_samples=B * prof.env_steps)
            prof.solve_rows = trace.solve_active(prof)
            prof.solves = []
    steps_ms = clk.intervals_ms()
    ctx.info.update(
        card=card.smi() if dev.type == "cuda" else "cpu",
        window_steps=n, window_s=wall,
        step_ms_p50=percentile(steps_ms, 50.0), launches_by_plan=plans,
        launches_per_step=sum(plans.values()) / max(n, 1),
        contact_overflow_max_checked=int(max(int(o) for o in overflow))
        if overflow else None, setup_s=setup_s)
    memory_peak = card.device_block(ctx.device, 1)["memory_peak_bytes"]
    ctx.obs_act = (env.obs_size, env.action_size)
    del env, net, states, obs, out
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ctx.caps = caps
    compared = check(ctx, caps)
    return dict(metrics={
        "rollout_env_steps_per_s": n * B / wall,
        "rollout_step_ms_p95": percentile(steps_ms, 95.0),
        "setup_s": setup_s}, attempted=n * B, failed=0,
        compared=compared, memory_peak_bytes=memory_peak)


def check(ctx, caps, candidate: str = "program"):
    """The compared numbers of the captured steps (``reference.check``);
    ``candidate="tf32"`` reads the control's."""
    import numpy as np

    from reference import check, policy

    cfg, tr = ctx.config, ctx.traffic
    ref = check.Reference(dict(
        env="dp_env", robot=cfg["robot"], motion=tr["motion"],
        max_contacts=tr.get("max_contacts", cfg["max_contacts"])),
        ctx.device)
    env = ref.env("float64")
    hp = tr["policy"]
    p0 = policy.init_params(env.obs_size, env.action_size, cfg["net_arch"],
                            hp["init_log_std"], ctx.seed)
    rows, resets, pol = [], 0, 0.0
    for cap in caps:
        act = check.policy_rows(p0, hp, cap["obs_in"], cap["noise"],
                                cap["action"], candidate=candidate)
        pol = max(pol, float(act.max()))
        rows.append(np.maximum(check.step_rows(ref, cap, candidate), act))
        if candidate == "program":
            resets += check.reset_rows(ref, cap)
    rows = np.concatenate(rows)
    ctx.info[f"step_gap_quantiles.{candidate}"] = {
        q: float(np.quantile(rows, q)) for q in (0.5, 0.9, 0.99, 0.999, 1.0)}
    return {"step_gap_p99": float(np.quantile(rows, 0.99)),
            "reset_mismatch": resets, "policy_gap": pol}
