"""Quick behavioral probe of a policy checkpoint.

The port of the JAX package's ``tools/probe.py``: rolls the
deterministic policy from several start frames and prints survival
time, root displacement and episode reward, the fast "what is this
policy actually doing" check (a full eval is tools/play.py /
rl/eval.py). Every start runs at once, as one masked batch: an env's
state freezes at its done step, as the JAX package's scan freezes it.

Usage:
  python -m deepmimic_mujoco_tpu_torch.tools.probe --motion run \\
      --robot unitree_g1 --policy pd --checkpoint best.pt
"""
from __future__ import annotations

import argparse

import torch


def probe(env, net, starts=(0, 10, 20, 30), max_steps=400):
    """One row per start frame: start, ep_rew, ep_len, reason (the done
    reason of the last live step), dx (root x moved from the start
    frame's mocap pose) and z (root height at the end)."""
    from deepmimic_mujoco_tpu_torch.envs.dp_env import DONE_REASON_NAMES
    from deepmimic_mujoco_tpu_torch.rl import networks

    n, dev = len(starts), env.device
    frames = [s % env.mocap_data_len for s in starts]
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    rew = torch.zeros(n, device=dev)
    ep_len = torch.zeros(n, dtype=torch.int64, device=dev)
    reason = torch.zeros(n, dtype=torch.int64, device=dev)
    with torch.no_grad():
        state, obs = env.reset(n, idx_init=frames)
        for _ in range(max_steps):
            mean = net(obs)[0]
            nstate, out = env.step(state, networks.env_action(net, obs, mean))
            rew += out.reward * alive
            ep_len += alive
            reason = torch.where(alive, out.done_reason, reason)
            state = type(state)(*[
                torch.where(alive.view((-1,) + (1,) * (a.dim() - 1)), a, b)
                for a, b in zip(nstate, state)])
            obs = torch.where(alive[:, None], out.obs, obs)
            alive = alive & ~out.done
    q0 = env.mocap_qpos[frames].cpu()
    qpos = state.qpos.cpu()
    rows = []
    for i, s in enumerate(starts):
        code = int(reason[i])
        rows.append(dict(
            start=s, ep_rew=float(rew[i]), ep_len=int(ep_len[i]),
            reason=DONE_REASON_NAMES.get(code, str(code)),
            dx=float(qpos[i, 0] - q0[i, 0]), z=float(qpos[i, 2])))
        r = rows[-1]
        print(f"start={s:3d} len={r['ep_len']:4d} rew={r['ep_rew']:8.2f} "
              f"dx={r['dx']:+6.2f} z={r['z']:.2f} ({r['reason']})")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--motion", default="run")
    p.add_argument("--robot", default="unitree_g1")
    p.add_argument("--policy", default="torque", choices=["torque", "pd"])
    p.add_argument("--checkpoint", required=True,
                   help="the port's params file, or an actor .npz "
                        "(torque policies)")
    p.add_argument("--max-steps", type=int, default=400)
    p.add_argument("--starts", type=int, nargs="+", default=[0, 10, 20, 30])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from deepmimic_mujoco_tpu_torch.envs import DPEnv
    from deepmimic_mujoco_tpu_torch.rl import checkpoint, networks
    from deepmimic_mujoco_tpu_torch.rl.convert import actor_from_npz

    env = DPEnv(motion=args.motion, robot=args.robot, device=args.device)
    if args.checkpoint.endswith(".npz"):
        net = actor_from_npz(args.checkpoint, device=env.device)
    else:
        net = networks.make_policy(args.policy, env, device=env.device)
        net.load_state_dict(checkpoint.restore_params(args.checkpoint,
                                                      net.state_dict()))
    return probe(env, net, starts=tuple(args.starts),
                 max_steps=args.max_steps)


if __name__ == "__main__":
    main()
