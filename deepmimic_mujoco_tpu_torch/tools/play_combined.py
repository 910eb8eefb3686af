"""Combined-env demo / playback (reference: src/combined_env.py:536-550).

Warm-starts the state machine by force-tracking the current motion for
the first ``--warmstart`` steps, then hands control to a policy (an actor
``.npz``, ``rl/convert.py``'s format, or the port's params file of an
``ActorCritic``, ``rl/checkpoint.py:save_params``, as
``tools/export_params.py`` writes it from a JAX params directory) or
small random actions; prints transitions and the episode reward.

Robustness probe: ``--inject-fall-every N`` force-sets a facedown pose
(getup clip frame 0, zero velocity) every N steps, once the policy is in
locomotion with amnesty earned, driving the fallen -> to_getup -> getup
-> walk|run path. A recovery cycle counts only when the robot is up
(root z > 0.5) at the getup -> locomotion switch, which fires on a timer
(the rule of tests/test_checkpoint_gates.py); ``--assert-cycles K``
turns the run into a regression gate. ``--video out.mp4`` renders
every 4th step with the motion's name, the step and the reward drawn on
it (FK on the card, the ray tracer on the host).

Usage: python -m deepmimic_mujoco_tpu_torch.tools.play_combined
           [--checkpoint actor.npz|params.pt] [--steps 2000] [--device cuda]
           [--inject-fall-every 400] [--assert-cycles 2]
"""
from __future__ import annotations

import argparse

import numpy as np

from deepmimic_mujoco_tpu_torch.envs.combined_env import (
    GETUP, MOTION_NAMES, RUN, TO_GETUP, WALK,
)

UP_Z = 0.5   # root z: G1 standing ~0.79, lying ~0.1


class CycleCounter:
    """Completed fall -> to_getup -> getup -> locomotion cycles, counted
    on motion transitions: a switch into TO_GETUP arms it, and a switch
    from GETUP into WALK or RUN with the root above ``UP_Z`` completes
    a cycle and disarms it. A switch made lying down leaves it armed."""

    def __init__(self):
        self.cycles = 0
        self.saw_to_getup = False

    def update(self, prev: int, cur: int, root_z: float) -> str:
        """Feed one step's (previous, current) motion id and the root
        height after it; returns "completed", "not up" or ""."""
        if cur == prev:
            return ""
        if cur == TO_GETUP:
            self.saw_to_getup = True
        elif cur in (WALK, RUN) and prev == GETUP and self.saw_to_getup:
            if root_z > UP_Z:
                self.cycles += 1
                self.saw_to_getup = False
                return "completed"
            return "not up"
        return ""


def main(argv=None):
    """Returns ``(ep_rew, cycles)``: the episode reward and the count of
    completed recovery cycles."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", default=None,
                   help="actor .npz (w0..bN, log_std) or the port's "
                        "params file")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--warmstart", type=int, default=500)
    p.add_argument("--video", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--inject-fall-every", type=int, default=0,
                   help="force a facedown pose every N steps (0 = off)")
    p.add_argument("--assert-cycles", type=int, default=0,
                   help="require >= K completed fall->getup->locomotion "
                        "recovery cycles")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from deepmimic_mujoco_tpu_torch.envs import DPCombinedEnv

    env = DPCombinedEnv(device=args.device)
    dev = env.device
    rng = np.random.default_rng(args.seed)
    if args.checkpoint:
        from deepmimic_mujoco_tpu_torch.rl import checkpoint, networks
        from deepmimic_mujoco_tpu_torch.rl.convert import actor_from_npz

        if args.checkpoint.endswith(".npz"):
            actor = actor_from_npz(args.checkpoint, device=dev)
        else:
            actor = networks.ActorCritic(env.obs_size, env.action_size,
                                         device=dev)
            actor.load_state_dict(checkpoint.restore_params(
                args.checkpoint, actor.state_dict()))
        policy = lambda o: actor(o)[0]
    else:
        policy = lambda o: torch.as_tensor(rng.uniform(
            -0.1, 0.1, (1, env.action_size)).astype(np.float32), device=dev)
        print("No checkpoint: playing small random actions")

    # facedown pose for fall injection: getup clip frame 0, zero velocity
    fall = (env.mocap_qpos[GETUP, :1], torch.zeros_like(
        env.mocap_qvel[GETUP, :1]))
    counter = CycleCounter()
    frames = []
    ep_rew = 0.0
    inject_armed = False
    with torch.no_grad():
        state, obs = env.reset(1, torch.Generator(device=dev).manual_seed(
            args.seed))
        last_motion = int(state.motion_id[0])
        print("start motion:", MOTION_NAMES[last_motion])
        for i in range(args.steps):
            a = policy(obs)
            # arm on the schedule tick; fire at the first step the robot
            # is in locomotion with amnesty earned (a tick that lands
            # mid-recovery is deferred, not dropped)
            if (args.inject_fall_every and i >= args.warmstart
                    and i % args.inject_fall_every == 0):
                inject_armed = True
            inject = (inject_armed
                      and int(state.motion_id[0]) in (WALK, RUN)
                      and int(state.n_steps[0]) > env.ENV_CFG.AMNESTY_STEPS)
            if inject:
                inject_armed = False
                print(f"step {i}: injecting fall (facedown force-state)")
                state, out = env.step(state, a, force_state=fall)
            elif i < args.warmstart:
                state, out = env.step(
                    state, a, force_state=env.get_current_motion_state(state))
            else:
                state, out = env.step(state, a)
            obs = out.obs
            ep_rew += float(out.reward[0])
            mid = int(state.motion_id[0])
            if mid != last_motion:
                print(f"step {i}: changing to motion: {MOTION_NAMES[mid]}")
                z = float(state.qpos[0, 2])
                seen = counter.update(last_motion, mid, z)
                if seen == "completed":
                    print(f"step {i}: recovery cycle #{counter.cycles} "
                          "complete")
                elif seen == "not up":
                    print(f"step {i}: getup timer expired NOT up (root z "
                          f"{z:.2f}): not counted as a recovery")
                last_motion = mid
            if args.video and i % 4 == 0:
                from deepmimic_mujoco_tpu_torch.tools.render import (
                    render_state,
                )

                frames.append(render_state(
                    env.model, state.qpos[0], mode="rgb_array",
                    overlay=f"{MOTION_NAMES[mid][-8:]} {i:>5} {ep_rew:>8.2f}",
                    device=dev))
            if bool(out.done[0]):
                print("done at", i, "reason code", int(out.done_reason[0]))
                break
    cycles = counter.cycles
    print(f"Episode reward: {ep_rew:.2f}  recovery cycles: {cycles}")
    if args.video and frames:
        from deepmimic_mujoco_tpu_torch.tools.render import frames_to_video

        print("Saved", frames_to_video(frames, args.video))
    if args.assert_cycles and cycles < args.assert_cycles:
        # SystemExit, not assert: the gate must survive python -O
        raise SystemExit(
            f"combined robustness gate: {cycles} < {args.assert_cycles} "
            "recovery cycles")
    return ep_rew, cycles


if __name__ == "__main__":
    main()
