"""Interactive viewer: live mocap playback and policy rollouts.

The port of the JAX package's ``tools/view.py`` (the reference inspects
behaviour through a live MjViewer window, src/deepmimic_env.py:527-538).
Frames come from ``tools/render.py`` (FK on the card, the ray tracer on
the host) and are shown in a matplotlib window with keyboard control.
Any interactive matplotlib backend works; under the headless Agg
backend the same loop runs without a window, which is how the tests
drive it.

Usage::

    python -m deepmimic_mujoco_tpu_torch.tools.view --motion walk
    python -m deepmimic_mujoco_tpu_torch.tools.view --motion walk \\
        --checkpoint runs/..._best.pt

Keys: space pause/resume - left/right step one frame while paused -
a/d orbit camera - w/s zoom - up/down playback speed - q quit.
"""
from __future__ import annotations

import argparse
import time

import torch


class Viewer:
    """Frame loop + camera/playback state.

    ``source`` is a callable ``(frame_idx) -> qpos``; the viewer owns
    azimuth/distance/pause/speed and renders through ``render_state``
    with FK on ``device``. Split from the window so tests can drive
    ``step_once``/``handle_key`` headless.
    """

    def __init__(self, model, source, overlay=None, width=480,
                 height=480, fps=30.0, device="cuda"):
        self.model = model
        self.source = source
        self.overlay = overlay or (lambda i: f"frame {i}")
        self.width, self.height = width, height
        self.fps = fps
        self.device = device
        self.azimuth = 155.0
        self.distance = 3.0
        self.paused = False
        self.speed = 1.0
        self.frame_idx = 0
        self.quit = False

    # ---- input ------------------------------------------------------
    def handle_key(self, key: str):
        if key == " ":
            self.paused = not self.paused
        elif key == "left" and self.paused:
            self.frame_idx = max(self.frame_idx - 1, 0)
        elif key == "right" and self.paused:
            self.frame_idx += 1
        elif key == "a":
            self.azimuth -= 10.0
        elif key == "d":
            self.azimuth += 10.0
        elif key == "w":
            self.distance = max(self.distance - 0.25, 0.75)
        elif key == "s":
            self.distance += 0.25
        elif key == "up":
            self.speed = min(self.speed * 1.5, 8.0)
        elif key == "down":
            self.speed = max(self.speed / 1.5, 0.125)
        elif key == "q":
            self.quit = True

    # ---- rendering --------------------------------------------------
    def step_once(self):
        """Advance (unless paused) and return the rendered frame."""
        from deepmimic_mujoco_tpu_torch.tools.render import render_state

        qpos = self.source(self.frame_idx)
        frame = render_state(
            self.model, qpos, mode="rgb_array",
            overlay=self.overlay(self.frame_idx),
            width=self.width, height=self.height,
            azimuth_deg=self.azimuth, distance=self.distance,
            device=self.device)
        if not self.paused:
            self.frame_idx += 1
        return frame

    def run(self):  # pragma: no cover - needs an interactive backend
        import matplotlib
        import matplotlib.pyplot as plt

        interactive = matplotlib.get_backend().lower() not in (
            "agg", "pdf", "svg", "ps", "template")
        fig, ax = plt.subplots(figsize=(6, 6))
        fig.canvas.manager.set_window_title("deepmimic_mujoco_tpu_torch")
        im = ax.imshow(self.step_once())
        ax.axis("off")
        fig.canvas.mpl_connect(
            "key_press_event", lambda ev: self.handle_key(ev.key))
        fig.canvas.mpl_connect(
            "close_event", lambda ev: setattr(self, "quit", True))
        while not self.quit:
            t0 = time.time()
            im.set_data(self.step_once())
            fig.canvas.draw_idle()
            if interactive:
                plt.pause(max(1.0 / (self.fps * self.speed)
                              - (time.time() - t0), 1e-3))
            else:
                break  # headless: single frame, no event loop
        plt.close(fig)


def mocap_source(env):
    """loop_motion equivalent (reference: src/mujoco/mocap_v2.py
    ``play``): cycle the clip's mocap qpos. Returns (source, frames)."""
    qpos = env.mocap_qpos.cpu().numpy()
    n = len(qpos)
    return lambda i: qpos[i % n], n


def policy_source(env, ckpt):
    """Live policy rollout (the reference's play_* scripts with
    render=True): one env on its device under the mean action of the
    ``ActorCritic`` in the port's params file ``ckpt``
    (``rl/checkpoint.save_params``), reset from generator seed 0 at
    frame 0 of the viewer and auto-reset when done."""
    from deepmimic_mujoco_tpu_torch.rl import checkpoint, networks

    net = networks.ActorCritic(env.obs_size, env.action_size,
                               device=env.device)
    net.load_state_dict(checkpoint.restore_params(ckpt, net.state_dict()))
    gen = torch.Generator(device=env.device)
    state = {"s": None, "o": None}

    def src(i):
        with torch.no_grad():
            if state["s"] is None or i == 0:
                gen.manual_seed(0)
                state["s"], state["o"] = env.reset(1, generator=gen)
            mean, _, _ = net(state["o"])
            state["s"], out = env.step_auto_reset(state["s"], mean, gen)
            state["o"] = out.obs
        return state["s"].qpos[0].cpu().numpy()

    return src


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--motion", default="walk")
    p.add_argument("--robot", default="humanoid3d")
    p.add_argument("--checkpoint", default=None,
                   help="the port's params file of an ActorCritic; omit "
                        "for mocap playback")
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from deepmimic_mujoco_tpu_torch.envs import DPEnv

    env = DPEnv(motion=args.motion, robot=args.robot, device=args.device)
    if args.checkpoint:
        src = policy_source(env, args.checkpoint)
        overlay = lambda i: f"{args.motion} policy step {i}"
    else:
        src, n = mocap_source(env)
        overlay = lambda i: f"{args.motion} frame {i % n}/{n}"
    Viewer(env.model, src, overlay, args.width, args.height, args.fps,
           device=env.device).run()


if __name__ == "__main__":
    main()
