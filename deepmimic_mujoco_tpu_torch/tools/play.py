"""Checkpoint playback / regression gate.

The port of the JAX package's ``tools/play.py`` (the reference's play_*
scripts: src/play_g1_run_polar_breeze.py, src/play_g1_walk_absurd_snow.py,
src/play_extracted.py): load a trained policy, run a deterministic
episode through ``GymDPEnv`` (one env, on the card by default), print
the initial qpos/qvel as JS arrays on request, and assert a minimum
episode reward as a regression gate (the reference asserts > 90 at
src/play_g1_run_polar_breeze.py:50).

A ``.npz`` checkpoint runs through the numpy ``ExtractedPolicy``, its
golden-vector self-test first: the extracted artifacts and the
``data/*_gate_actor.npz`` files share the ``w0..bN`` keys. Any other
path is the port's params file (``rl/checkpoint.py:save_params``) of a
``--policy`` net. ``--video out.mp4`` renders every 2nd step
(``GymDPEnv.render``: FK on the card, the ray tracer on the host).

Usage:
  python -m deepmimic_mujoco_tpu_torch.tools.play --motion run \\
      --robot unitree_g1 --checkpoint run_extracted.npz --assert-reward 90
"""
from __future__ import annotations

import argparse

import numpy as np

from deepmimic_mujoco_tpu_torch.envs.gym_wrapper import GymDPEnv


def log_actobs(step_i, action, obs):
    """Print action/obs as JS arrays (reference: src/play_extracted.py)."""
    print(f"// step {step_i}")
    print("action = [", ", ".join(f"{x:.6f}" for x in np.asarray(action)),
          "];")
    print("obs = [", ", ".join(f"{x:.6f}" for x in np.asarray(obs)), "];")


def load_policy(path, policy_kind, env):
    """obs (numpy) -> env action (numpy) of the checkpoint at ``path``."""
    if path.endswith(".npz"):
        from deepmimic_mujoco_tpu_torch.rl.extracted_policy import (
            ExtractedPolicy,
        )

        ep = ExtractedPolicy(path)
        if ep.golden is not None:
            ep.test()
            print("Extracted policy golden-vector test OK")
        return ep.act

    import torch

    from deepmimic_mujoco_tpu_torch.rl import checkpoint, networks

    dev = env.env.device
    net = networks.make_policy(policy_kind, env.env, device=dev)
    net.load_state_dict(checkpoint.restore_params(path, net.state_dict()))

    def act(o):
        with torch.no_grad():
            o = torch.as_tensor(np.asarray(o, np.float32), device=dev)
            return networks.env_action(net, o, net(o)[0]).cpu().numpy()
    return act


def main(argv=None):
    """Returns the episode reward."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--motion", default="walk")
    p.add_argument("--robot", default="humanoid3d")
    p.add_argument("--checkpoint", default=None,
                   help="the port's params file or an actor .npz")
    p.add_argument("--policy", default="torque",
                   choices=["torque", "pd"],
                   help="policy parameterization the checkpoint was "
                        "trained with (see rl/networks.py:make_policy)")
    p.add_argument("--idx-init", type=int, default=20)
    p.add_argument("--max-steps", type=int, default=1000)
    p.add_argument("--assert-reward", type=float, default=None)
    p.add_argument("--video", default=None)
    p.add_argument("--print-js", action="store_true",
                   help="print init qpos/qvel as JS arrays")
    p.add_argument("--log-actobs", action="store_true")
    p.add_argument("--warm-start-lam", action=argparse.BooleanOptionalAction,
                   default=None)
    p.add_argument("--mesh-subcapsules", type=int, default=None)
    p.add_argument("--rk4", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from deepmimic_mujoco_tpu_torch.models.physics_model import RK4

    eng_kw = {k: v for k, v in dict(
        warm_start_lam=args.warm_start_lam,
        mesh_subcapsules=args.mesh_subcapsules,
        integrator=RK4 if args.rk4 else None).items() if v is not None}
    env = GymDPEnv(motion=args.motion, robot=args.robot, device=args.device,
                   **eng_kw)
    obs = env.reset_model(idx_init=args.idx_init)

    if args.print_js:
        print("qpos = [", ", ".join(f"{x:.6f}" for x in env.sim_qpos), "];")
        print("qvel = [", ", ".join(f"{x:.6f}" for x in env.sim_qvel), "];")

    if args.checkpoint is None:
        policy = lambda o: np.zeros(env.action_space.shape[0], np.float32)
        print("No checkpoint: playing zero-torque policy")
    else:
        policy = load_policy(args.checkpoint, args.policy, env)

    frames = []
    ep_rew = 0.0
    for i in range(args.max_steps):
        a = policy(obs)
        if args.log_actobs:
            log_actobs(i, a, obs)
        obs, r, done, info = env.step(a)
        ep_rew += r
        if args.video and i % 2 == 0:
            frames.append(env.render(mode="rgb_array"))
        if done:
            print("done_reason:", info.get("done_reason", ""))
            break

    print(f"Episode reward: {ep_rew:.2f} over {env.episode_length} steps")
    if args.video and frames:
        from deepmimic_mujoco_tpu_torch.tools.render import frames_to_video

        print("Saved", frames_to_video(frames, args.video))
    if args.assert_reward is not None:
        if not ep_rew > args.assert_reward:
            raise AssertionError(f"Regression gate failed: {ep_rew:.2f} <= "
                                 f"{args.assert_reward}")
        print(f"Regression gate OK (> {args.assert_reward})")
    return ep_rew


if __name__ == "__main__":
    main()
