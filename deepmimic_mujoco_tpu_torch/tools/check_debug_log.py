"""Crash-log replay: inspect a divergence dump.

The port of the JAX package's ``tools/check_debug_log.py`` (reference:
src/check_debug_log.py:1-47). Loads a ``deepmimic_episode_*.json`` dump
that ``GymDPEnv`` writes on divergence (``envs/gym_wrapper.py``), plots
its actions, root position and rewards, and with ``--video`` renders
every 2nd recorded qpos (FK on ``--device``, the ray tracer on the
host).

Usage: python -m deepmimic_mujoco_tpu_torch.tools.check_debug_log
           <dump.json> [--video out.mp4] [--plot plots.png]
           [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np


def load_dump(path: str) -> dict:
    """The dump at ``path``, with ``qpos`` as an array; prints its
    robot, motion, length and the start of its traceback."""
    with open(path) as f:
        log = json.load(f)
    log["qpos"] = np.asarray(log["qpos"])
    print(f"dump: robot={log.get('robot', 'humanoid3d')} "
          f"motion={log.get('motion')} steps={len(log['qpos'])}")
    print("traceback:", log.get("full_traceback", "")[:200])
    return log


def plot_dump(log: dict, path: str) -> str:
    """Actions, root xyz and rewards of the dump, in three panels."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    actions = np.asarray(log.get("action", []))
    rewards = np.asarray(log.get("reward", []))
    fig, axs = plt.subplots(3, 1, figsize=(10, 9))
    if len(actions):
        axs[0].plot(actions)
        axs[0].set_title("actions")
    axs[1].plot(log["qpos"][:, :3])
    axs[1].set_title("root xyz")
    if len(rewards):
        axs[2].plot(rewards)
        axs[2].set_title("reward")
    fig.savefig(path)
    plt.close(fig)
    print("plots saved to", path)
    return path


def dump_video(log: dict, path: str, device="cuda") -> str:
    """Every 2nd recorded qpos rendered, its index drawn on it."""
    from deepmimic_mujoco_tpu_torch.models import assets, load_model
    from deepmimic_mujoco_tpu_torch.tools.render import (
        frames_to_video, render_state,
    )

    model = load_model(assets.xml_path(log.get("robot", "humanoid3d")))
    frames = [render_state(model, q, mode="rgb_array", overlay=f"{i}",
                           device=device)
              for i, q in enumerate(log["qpos"][::2])]
    print("Saved", frames_to_video(frames, path))
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dump")
    p.add_argument("--video", default=None)
    p.add_argument("--plot", default=os.path.join(tempfile.gettempdir(),
                                                  "debug_log_plots.png"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    log = load_dump(args.dump)
    plot_dump(log, args.plot)
    if args.video:
        dump_video(log, args.video, args.device)


if __name__ == "__main__":
    main()
