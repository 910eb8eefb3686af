"""Training entry point:
``python -m deepmimic_mujoco_tpu_torch.rl.train <reason> [--env ...]``.

The port of the JAX package's PPO trainer CLI (reference:
src/sb3_ppo.py:244-314): the run-reason guard, a config snapshot, JSONL
metrics (wandb when it is importable and not turned off), threaded
evaluations with best-params saves, and a final train-state checkpoint.
A failed evaluation does not stop training, but ``main`` raises it once
the final checkpoint is saved.
Thousands of envs step as one batch on the card (``--device``, default
cuda). The default ``--env`` is the combined walk/run/getup env, with
its handoff and facedown options; ``--rk4`` trains under RK4. Every 5th
evaluation writes the eval dashboard's video and plots (cv2 and
matplotlib, checked before training starts); ``--no-render`` turns them
off.
"""
from __future__ import annotations

import argparse
import json
import os
import time

M = 1_000_000


def parse_reason(argv=None, required=True):
    """Free-text run reason guard (reference: src/sb3_ppo.py:232-242)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("reason", nargs="?", default="")
    p.add_argument("--env", default="dp_combined_env",
                   choices=["deep_mimic_mujoco", "dp_combined_env"])
    p.add_argument("--motion", default="walk")
    p.add_argument("--robot", default="unitree_g1")
    p.add_argument("--speed", type=float, default=1.0,
                   help="mocap time-stretch for curriculum training "
                        "(0.5 = half-speed clip)")
    p.add_argument("--n-envs", type=int, default=2048)
    p.add_argument("--horizon", type=int, default=64)
    p.add_argument("--minibatch", type=int, default=4096)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--lr", type=float, default=4e-4)
    p.add_argument("--target-kl", type=float, default=None)
    p.add_argument("--adaptive-lr", action="store_true",
                   help="adapt lr to hold epoch-1 KL near --target-kl "
                        "(x0.7 when over 1.5x, x1.05 when under 0.5x)")
    p.add_argument("--lr-final-frac", type=float, default=1.0,
                   help="linear lr decay to lr*frac over the run")
    p.add_argument("--clip-vf", type=float, default=None)
    p.add_argument("--adv-std-floor", type=float, default=1e-3,
                   help="floor on per-minibatch advantage std; raise "
                        "(~0.1) when shaping makes rewards near-"
                        "constant")
    p.add_argument("--init-log-std", type=float, default=0.0)
    p.add_argument("--log-std-min", type=float, default=-4.0,
                   help="hard floor on the learned log-std")
    p.add_argument("--init-params", default=None,
                   help="warm-start policy/value params from a "
                        "params-only checkpoint (e.g. an eval '_best.pt')")
    p.add_argument("--reset-log-std", type=float, default=None,
                   help="with --init-params: overwrite the checkpoint's "
                        "log-std (re-open exploration for the new task)")
    p.add_argument("--alive-bonus", type=float, default=0.0,
                   help="training-only survival shaping added to "
                        "non-terminal GAE rewards; logged metrics stay on "
                        "the true reward")
    p.add_argument("--policy", default="torque",
                   choices=["torque", "pd"],
                   help="action parameterization: raw torque (reference "
                        "parity) or PD-delta (the deployed policy is "
                        "still obs->torque)")
    p.add_argument("--vel-shaping", type=float, default=0.0,
                   help="training-only root planar-velocity-match "
                        "shaping weight; annealed with --alive-bonus-decay")
    p.add_argument("--alive-bonus-decay", type=int, default=0,
                   help="global steps over which --alive-bonus anneals "
                        "linearly to 0 (0 = constant)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--total", type=int, default=500 * M)
    p.add_argument("--eval-every", type=int, default=500_000)
    p.add_argument("--preset", default="sb3",
                   choices=["sb3", "legacy-ppo2"],
                   help="legacy-ppo2 mirrors the reference's SB2 PPO2 "
                        "script hyperparams (horizon 128, 4 epochs, "
                        "lr 2.5e-4; reference: src/ppo.py:16-42)")
    p.add_argument("--no-wandb", action="store_true")
    p.add_argument("--no-render", action="store_true")
    p.add_argument("--out", default="~/deep_mimic")
    p.add_argument("--device", default="cuda",
                   help="torch device of the envs and the policy")
    # engine-semantics knobs
    p.add_argument("--warm-start-lam", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="carry solver forces across steps (engine "
                        "warm start); default = engine default")
    p.add_argument("--mesh-subcapsules", type=int, default=None,
                   help="per-link capsule proxies for mesh "
                        "self-collision (G1); default = engine default")
    p.add_argument("--rk4", action="store_true",
                   help="train under RK4 (reference MJCF integrator) "
                        "instead of semi-implicit Euler")
    p.add_argument("--handoff-rsi", type=float, default=0.0,
                   help="combined env: fraction of resets placed in "
                        "the last quarter of the getup clip")
    p.add_argument("--rsi-random-pa", action="store_true",
                   help="combined env: randomize reset player action "
                        "between walk and run")
    p.add_argument("--handoff-buffer", type=float, default=0.0,
                   help="combined env: fraction of resets drawn from "
                        "the on-policy handoff buffer (states captured "
                        "at GETUP->locomotion transitions during "
                        "rollout)")
    p.add_argument("--handoff-buffer-cap", type=int, default=4096,
                   help="accepted for the JAX CLI's command lines; like "
                        "there, its value reaches nothing (the buffer "
                        "keeps PPOConfig.handoff_buffer_cap, 4096)")
    p.add_argument("--facedown-rsi", type=float, default=0.0,
                   help="fraction of combined-env resets at getup "
                        "frame 0 with zero velocity (the injected-"
                        "fall state) so full recovery is practiced")
    args = p.parse_args(argv)
    if required and not args.reason and not args.no_wandb:
        raise ValueError("Please provide a reason for this run")
    print("Reason:", args.reason)
    return args


# what the eval dashboard draws with: cv2 (overlay text, the mp4) and
# matplotlib (the panel and the plots)
RENDER_MODULES = ("cv2", "matplotlib")


def missing_render_modules() -> list:
    """The modules of ``RENDER_MODULES`` that this Python lacks."""
    import importlib.util

    return [m for m in RENDER_MODULES if importlib.util.find_spec(m) is None]


def build(args):
    """(env, PPOConfig) that parsed ``args`` ask for, the env on
    ``args.device``."""
    from deepmimic_mujoco_tpu_torch.envs import (
        DPCombinedEnv, DPCombinedEnvConfig, DPEnv,
    )
    from deepmimic_mujoco_tpu_torch.models.physics_model import RK4
    from deepmimic_mujoco_tpu_torch.rl.ppo import PPOConfig

    eng_kw = {k: v for k, v in dict(
        warm_start_lam=args.warm_start_lam,
        mesh_subcapsules=args.mesh_subcapsules,
        integrator=RK4 if args.rk4 else None).items() if v is not None}
    if args.env == "deep_mimic_mujoco":
        env = DPEnv(motion=args.motion, robot=args.robot, speed=args.speed,
                    device=args.device, **eng_kw)
    else:
        ccfg = DPCombinedEnvConfig(
            HANDOFF_RSI_FRAC=args.handoff_rsi,
            RSI_RANDOM_PA=args.rsi_random_pa,
            HANDOFF_BUFFER_FRAC=args.handoff_buffer,
            FACEDOWN_RSI_FRAC=args.facedown_rsi)
        env = DPCombinedEnv(cfg=ccfg, device=args.device, **eng_kw)

    if args.preset == "legacy-ppo2":
        cfg = PPOConfig(n_envs=args.n_envs, horizon=128,
                        minibatch_size=args.minibatch, epochs=4,
                        lr=2.5e-4, total_timesteps=args.total)
    else:
        cfg = PPOConfig(n_envs=args.n_envs, horizon=args.horizon,
                        minibatch_size=args.minibatch, epochs=args.epochs,
                        lr=args.lr, total_timesteps=args.total,
                        target_kl=args.target_kl,
                        lr_final_frac=args.lr_final_frac,
                        clip_vf=args.clip_vf,
                        adv_std_floor=args.adv_std_floor,
                        alive_bonus=args.alive_bonus,
                        alive_bonus_decay_steps=args.alive_bonus_decay,
                        vel_shaping=args.vel_shaping,
                        policy=args.policy,
                        log_std_min=args.log_std_min,
                        adaptive_lr_kl=args.adaptive_lr,
                        init_log_std=args.init_log_std)
    return env, cfg


def main(argv=None):
    args = parse_reason(argv)
    missing = [] if args.no_render else missing_render_modules()
    if missing:
        # before any training: a failed evaluation is raised only at the end
        raise ImportError(f"the eval dashboard needs {' and '.join(missing)}"
                          ", which this Python lacks; pass --no-render")

    import torch

    from deepmimic_mujoco_tpu_torch.rl import checkpoint
    from deepmimic_mujoco_tpu_torch.rl.eval import ThreadedEvaluator
    from deepmimic_mujoco_tpu_torch.rl.ppo import PPO

    env, cfg = build(args)
    ppo = PPO(env, cfg)
    init_params = None
    if args.init_params:
        template = ppo.make_net().state_dict()
        init_params = checkpoint.restore_params(args.init_params, template)
        print("Warm-starting params from", args.init_params)
        if any(init_params[k].shape != template[k].shape
               for k in template if k in init_params):
            init_params = checkpoint.adapt_params(init_params, template)
            print("Adapted warm-start params to the wider obs input "
                  "(zero-padded first-layer columns)")
        if args.reset_log_std is not None:
            init_params["log_std"] = torch.full_like(
                init_params["log_std"], args.reset_log_std)
            print("Reset log_std to", args.reset_log_std)

    run_name = "test" + time.strftime("%Y%m%d-%H%M_%S")
    config = {
        "run_reason": args.reason, "policy_type": "ActorCritic",
        "total_timesteps": args.total, "env_name": args.env,
        "version": env.version, "env_cfg": vars(env.ENV_CFG),
        "motion": args.motion, "robot": args.robot, "speed": args.speed,
        "arch": list(cfg.net_arch), "n_envs": cfg.n_envs,
        "horizon": cfg.horizon, "minibatch_size": cfg.minibatch_size,
        "learning_rate": cfg.lr, "epochs": cfg.epochs,
        "device": str(env.device),
        "machine_name": os.environ.get("MACHINE_NAME", "unknown"),
    }

    out_dir = os.path.expanduser(args.out)
    os.makedirs(out_dir, exist_ok=True)
    metrics_path = os.path.join(out_dir, run_name + "_metrics.jsonl")
    with open(metrics_path, "w") as f:
        f.write(json.dumps({"config": config}) + "\n")

    wandb_run = None
    if not args.no_wandb:
        try:
            import wandb

            wandb_run = wandb.init(project="deep_mimic", config=config)
        except Exception as e:
            print("wandb unavailable, logging to", metrics_path, f"({e})")

    def log_metrics(d):
        with open(metrics_path, "a") as f:
            f.write(json.dumps(d) + "\n")
        if wandb_run is not None:
            wandb_run.log(d)

    evaluator = ThreadedEvaluator(ppo, args.motion + "_" + run_name,
                                  out_dir=args.out,
                                  render=not args.no_render,
                                  metrics_cb=log_metrics)
    steps_per_iter = cfg.n_envs * cfg.horizon
    eval_every_iters = max(args.eval_every // steps_per_iter, 1)

    def callback(it, ts, stats):
        gstep = (it + 1) * steps_per_iter
        extra = {}
        if stats.handoff_count is not None:
            extra["handoff_count"] = int(stats.handoff_count)
        log_metrics({
            **extra,
            "global_step": gstep,
            "mean_reward": float(stats.mean_reward),
            "ep_return": float(stats.ep_return_sum)
            / max(float(stats.ep_count), 1.0),
            "ep_length": float(stats.ep_len_sum)
            / max(float(stats.ep_count), 1.0),
            "pg_loss": float(stats.pg_loss), "v_loss": float(stats.v_loss),
            "entropy": float(stats.entropy),
            "approx_kl": float(stats.approx_kl),
            "clip_frac": float(stats.clip_frac),
            "log_std_mean": float(stats.log_std_mean),
            "v_loss_max": float(stats.v_loss_max),
            "lr_scale": float(stats.lr_scale),
            "contact_overflow_max": int(stats.contact_overflow_max),
        })
        if it % eval_every_iters == 0:
            # dashboard videos only every 5th eval: matplotlib holds the
            # GIL long enough to slow the training loop
            render = (not args.no_render) and \
                (it // eval_every_iters) % 5 == 0
            evaluator.queue_eval(ts.net, gstep, render=render)

    print("Begin Learn")
    print("-----------")
    try:
        ts = ppo.train(total_timesteps=args.total, callback=callback,
                       seed=args.seed, init_params=init_params)
    finally:
        evaluator.stop()
    path = checkpoint.save(os.path.join(out_dir, run_name + ".pt"), ts)
    print("Saved final checkpoint to", path)
    if evaluator.errors:
        # training went on past them; the run still fails
        raise RuntimeError(
            f"{len(evaluator.errors)} evaluation(s) failed, the first with "
            f"{evaluator.errors[0]!r}") from evaluator.errors[0]
    return ts


if __name__ == "__main__":
    main()
