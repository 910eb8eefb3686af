"""SAC training entry point:
``python -m deepmimic_mujoco_tpu_torch.rl.sac_train [reason] [--...]``.

The port of the JAX package's SAC trainer CLI (reference:
src/sac_sb3.py:20-89, DPEnv over 32 subprocess envs, buffer 5M,
net_arch [1024, 512]). It keeps every flag of the JAX CLI, adds
``--device`` (default cuda), and writes the same metrics JSONL as the
JAX CLI: a config row, then one row per iteration. Every
``--eval-every`` env steps a deterministic episode (1000 steps from
``--idx-init``, action ``tanh(mean) * action_scale``) scores the actor
and the best one is saved; the final actor is saved at the end, both in
the SAC actor npz format (``rl/convert.py``).

``--init-actor-from-ppo`` distills the SAC actor from a PPO policy
first (``distill_actor_from_ppo``).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

M = 1_000_000
DISTILL_HORIZON = 64
DISTILL_BATCH = 4096
# the PPO actions are clipped inside the tanh range before arctanh
DISTILL_CLIP = 0.995


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("reason", nargs="?", default="")
    p.add_argument("--motion", default="walk")
    p.add_argument("--robot", default="humanoid3d")
    p.add_argument("--n-envs", type=int, default=256)
    p.add_argument("--buffer", type=int, default=1_000_000)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--steps-per-iter", type=int, default=32)
    p.add_argument("--updates-per-iter", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--arch", type=int, nargs="+", default=[1024, 512])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--total", type=int, default=10 * M)
    p.add_argument("--out", default="~/deep_mimic")
    p.add_argument("--eval-every", type=int, default=2 * M,
                   help="deterministic-eval cadence (env steps); the "
                        "best-scoring actor is checkpointed")
    p.add_argument("--idx-init", type=int, default=20,
                   help="eval episode start frame")
    p.add_argument("--warm-start-lam", action=argparse.BooleanOptionalAction,
                   default=None)
    p.add_argument("--mesh-subcapsules", type=int, default=None)
    p.add_argument("--alpha-lr", type=float, default=1e-4)
    p.add_argument("--actor-lr", type=float, default=None)
    p.add_argument("--log-alpha-min", type=float, default=-4.6)
    p.add_argument("--critic-warmup", type=int, default=0,
                   help="env steps with the actor frozen (critic fits "
                        "the warm-start data distribution first)")
    p.add_argument("--init-actor-from-ppo", default=None,
                   help="distill the SAC actor from a gated PPO policy "
                        "before training (behavior cloning on states "
                        "visited by it): the port's params file "
                        "(checkpoint.save_params) or an actor npz "
                        "(w0..bN, e.g. data/h3d_walk_gate_actor.npz). "
                        "The JAX package's orbax directories cannot be "
                        "read by the port")
    p.add_argument("--device", default="cuda",
                   help="torch device of the envs, the nets and the "
                        "replay buffer")
    args = p.parse_args(argv)
    print("Reason:", args.reason or "(none)")
    return args


def load_ppo_policy(path: str, env):
    """The PPO ``ActorCritic`` at ``path`` (an actor npz, or the port's
    params file of a torque policy), on the env's device."""
    from deepmimic_mujoco_tpu_torch.rl import checkpoint, networks
    from deepmimic_mujoco_tpu_torch.rl.convert import actor_from_npz

    path = os.path.expanduser(path)
    if path.endswith(".npz"):
        return actor_from_npz(path, device=env.device)
    net = networks.ActorCritic(env.obs_size, env.action_size,
                               device=env.device)
    net.load_state_dict(checkpoint.restore_params(path, net.state_dict()))
    return net


def collect_ppo_states(env, ppo_net, n_rollout: int, generator,
                       horizon: int = DISTILL_HORIZON):
    """``n_rollout`` RSI envs stepped ``horizon`` times under the PPO
    mean action; returns (obs, action), each (horizon * n_rollout, ...)
    in step-major order: the states the PPO policy visits and what it
    does there."""
    obs_tr, act_tr = [], []
    with torch.no_grad():
        states, obs = env.reset(n_rollout, generator=generator)
        for _ in range(horizon):
            a = ppo_net(obs)[0]
            obs_tr.append(obs)
            act_tr.append(a)
            states, out = env.step_auto_reset(states, a, generator)
            obs = out.obs
    return (torch.stack(obs_tr).reshape(-1, env.obs_size),
            torch.stack(act_tr).reshape(-1, env.action_size))


def bc_loss(actor, obs, target_z, init_log_std: float):
    """mse(mean, target) + 0.1 mse(log_std, init_log_std)."""
    mean, log_std = actor(obs)
    return (((mean - target_z) ** 2).mean()
            + 0.1 * ((log_std - init_log_std) ** 2).mean())


def bc_fit(actor, obs_d, act_d, steps: int, lr: float, init_log_std: float,
           draw_idx):
    """Behavior cloning of ``actor`` on (obs_d, act_d): ``steps`` Adam
    steps (optax.adam's defaults) on minibatches ``draw_idx(n)`` of the
    rows, regressing the mean to arctanh(clip(act, +-0.995)). Returns
    the (steps,) losses, each at the params before its step."""
    from deepmimic_mujoco_tpu_torch.rl.ppo import Adam
    from deepmimic_mujoco_tpu_torch.rl.sac import ADAM_EPS

    target_z = torch.atanh(torch.clamp(act_d, -DISTILL_CLIP, DISTILL_CLIP))
    params = list(actor.parameters())
    opt = Adam(params, eps=ADAM_EPS)
    nb = obs_d.shape[0]
    losses = []
    for i in range(steps):
        idx = draw_idx(nb)
        loss = bc_loss(actor, obs_d[idx], target_z[idx], init_log_std)
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        opt.step(lr)
        losses.append(loss.detach())
        if i % 500 == 0:
            print(f"distill step {i}: bc loss {float(losses[-1]):.5f}",
                  flush=True)
    losses = torch.stack(losses)
    print(f"distill done: bc loss {float(losses[-1]):.5f}")
    return losses


def distill_actor_from_ppo(sac, env, ppo_ckpt, n_rollout: int = 4096,
                           steps: int = 3000, lr: float = 3e-4,
                           init_log_std: float = -1.0, seed: int = 0):
    """Behavior-clone the SAC actor from a PPO policy.

    Rolls the deterministic PPO policy over ``n_rollout`` RSI envs for
    64 steps (on-policy state coverage), then regresses the actor's mean
    to arctanh of the PPO action, clipped inside the tanh range (the
    gated walk policy emits |a| > 1 on some dims), and pins its log-std
    near ``init_log_std``: warm-starting from a gated PPO policy turns
    SAC training into fine-tuning. Returns (actor state dict, the BC
    losses)."""
    dev = env.device
    ppo_net = load_ppo_policy(ppo_ckpt, env)
    g = torch.Generator(device=dev).manual_seed(seed)
    obs_d, act_d = collect_ppo_states(env, ppo_net, n_rollout, g)
    actor = sac.make_actor(torch.Generator().manual_seed(seed + 1))
    losses = bc_fit(actor, obs_d, act_d, steps, lr, init_log_std,
                    lambda nb: torch.randint(0, nb, (DISTILL_BATCH,),
                                             generator=g, device=dev))
    return actor.state_dict(), losses


def eval_episode(env, actor, idx_init: int, action_scale: float = 1.0,
                 max_steps: int = 1000) -> float:
    """The deterministic evaluation: one episode from frame ``idx_init``
    under tanh(mean) * action_scale, its reward summed until done (the
    JAX CLI freezes the state after done for the rest of its 1000
    steps, which adds nothing)."""
    total = 0.0
    with torch.no_grad():
        state, obs = env.reset(1, idx_init=idx_init)
        for _ in range(max_steps):
            mean, _ = actor(obs)
            state, out = env.step(state, torch.tanh(mean) * action_scale)
            total += float(out.reward[0])
            if bool(out.done[0]):
                break
            obs = out.obs
    return total


def build(args):
    """(env, SACConfig) that parsed ``args`` ask for: a ``DPEnv`` of
    ``args.robot`` and ``args.motion`` on ``args.device``."""
    from deepmimic_mujoco_tpu_torch.envs import DPEnv
    from deepmimic_mujoco_tpu_torch.rl.sac import SACConfig

    eng_kw = {k: v for k, v in dict(
        warm_start_lam=args.warm_start_lam,
        mesh_subcapsules=args.mesh_subcapsules).items() if v is not None}
    env = DPEnv(motion=args.motion, robot=args.robot, device=args.device,
                **eng_kw)
    cfg = SACConfig(n_envs=args.n_envs, buffer_size=args.buffer,
                    batch_size=args.batch,
                    steps_per_iter=args.steps_per_iter,
                    updates_per_iter=args.updates_per_iter,
                    lr=args.lr, net_arch=tuple(args.arch),
                    total_timesteps=args.total,
                    alpha_lr=args.alpha_lr,
                    actor_lr=args.actor_lr,
                    log_alpha_min=args.log_alpha_min,
                    critic_warmup_steps=args.critic_warmup)
    return env, cfg


def main(argv=None):
    args = parse_args(argv)

    from deepmimic_mujoco_tpu_torch.rl import checkpoint
    from deepmimic_mujoco_tpu_torch.rl.sac import SAC

    env, cfg = build(args)
    sac = SAC(env, cfg)

    init_actor = None
    if args.init_actor_from_ppo:
        init_actor, _ = distill_actor_from_ppo(
            sac, env, args.init_actor_from_ppo)

    run_name = "sac" + time.strftime("%Y%m%d-%H%M_%S")
    out_dir = os.path.expanduser(args.out)
    os.makedirs(out_dir, exist_ok=True)
    metrics_path = os.path.join(out_dir, run_name + "_metrics.jsonl")
    config = {"algo": "SAC", "run_reason": args.reason,
              "motion": args.motion, "robot": args.robot,
              "arch": list(cfg.net_arch), "n_envs": cfg.n_envs,
              "buffer_size": cfg.buffer_size, "batch_size": cfg.batch_size,
              "learning_rate": cfg.lr, "total_timesteps": args.total}
    with open(metrics_path, "w") as f:
        f.write(json.dumps({"config": config}) + "\n")
    print("Logging to", metrics_path)

    per_iter = cfg.n_envs * cfg.steps_per_iter
    best = {"rew": float("-inf")}
    eval_every_iters = max(args.eval_every // per_iter, 1)

    def callback(it, s, stats):
        r, closs, aloss, eps, epc, epl, alpha = (float(x) for x in stats)
        row = {
            "global_step": (it + 1) * per_iter,
            "mean_reward": r,
            "ep_return": eps / max(epc, 1.0),
            "ep_length": epl / max(epc, 1.0),
            "critic_loss": closs, "actor_loss": aloss,
            "alpha": alpha,
        }
        if (it + 1) % eval_every_iters == 0:
            rew = eval_episode(env, s.actor, args.idx_init, cfg.action_scale)
            row["eval_ep_rew"] = rew
            print(f"Eval: EP_REW {rew:.2f}", flush=True)
            if rew > best["rew"]:
                best["rew"] = rew
                checkpoint.save_sac_actor_npz(
                    os.path.join(out_dir, run_name + "_best_actor"), s.actor)
        with open(metrics_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    s = sac.train(total_timesteps=args.total, seed=args.seed,
                  callback=callback, init_actor=init_actor)

    path = checkpoint.save_sac_actor_npz(
        os.path.join(out_dir, run_name + "_actor"), s.actor)
    print("Saved actor params to", path)
    print(f"Best eval ep_rew: {best['rew']:.2f}")
    return s


if __name__ == "__main__":
    main()
