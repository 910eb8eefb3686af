"""Evaluation: a deterministic episode, its dashboard video and plots,
its CSV log and best-params save, and a worker thread that runs
evaluations beside training.

The port of the JAX package's ``rl/eval.py`` (reference:
src/sb3_ppo.py:25-140). The episode runs one env under the policy's
mean action until it is done: the JAX package runs a fixed-length scan
with the carry frozen and the reward masked after that (as the gate
tests mask it), which gives the same trajectory. With ``render`` the
dashboard draws a 2x2 panel a frame (actions, the rendered state,
cumulative/step reward and value, obs) on matplotlib's Agg into
``global_step_{n}.mp4``. The reward and length plots of the CSV log are
redrawn at every evaluation of a rendering run, as in the JAX package,
also those that draw no video; an evaluation with neither needs no
matplotlib and no cv2.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from deepmimic_mujoco_tpu_torch.rl import checkpoint, networks


def eval_rollout(ppo, net, env=None, max_steps: int = 1000, seed: int = 0,
                 idx_init: Optional[int] = None) -> dict:
    """Deterministic episode; returns a dict of stacked host arrays (obs,
    action, reward, value, qpos, done_reason) sliced to the episode
    length, with ``ep_rew`` and ``ep_len``.

    ``idx_init=None`` uses reference-state initialization like the
    reference's eval (a pinned frame 0 is a standing start the policy
    never trains from). A combined env (no ``mocap_data_len``) always
    starts from its own reset draws."""
    env = env or ppo.env
    traj = _episode_fn(ppo, env, idx_init, max_steps)(
        net, torch.Generator(device=env.device).manual_seed(seed))
    ep_len = int(traj.pop("alive").sum())
    out = {k: v[:ep_len] for k, v in traj.items()}
    out["ep_rew"] = float(traj["reward"].sum())
    out["ep_len"] = ep_len
    return out


def _episode_fn(ppo, env, idx_init, max_steps: int):
    """The episode as a function of (net, generator). Once the episode
    is done the JAX package freezes its carry and masks the remaining
    steps, which the host slices off; here the loop stops there."""

    def episode(net, generator):
        rec = {k: [] for k in ("obs", "action", "reward", "value", "qpos",
                               "done_reason", "alive")}
        with torch.no_grad():
            if idx_init is None or not hasattr(env, "mocap_data_len"):
                # RSI, and the combined env's own reset draws
                state, obs = env.reset(1, generator=generator)
            else:
                state, obs = env.reset(1, generator=generator,
                                       idx_init=idx_init)
            for _ in range(max_steps):
                mean, _, value = net(obs)
                mean = networks.env_action(net, obs, mean)
                state, out = env.step(state, mean)
                for k, v in (("obs", obs), ("action", mean),
                             ("reward", out.reward), ("value", value),
                             ("qpos", state.qpos),
                             ("done_reason", out.done_reason),
                             ("alive", torch.ones_like(out.done))):
                    rec[k].append(v[0].cpu())
                obs = out.obs
                if bool(out.done[0]):
                    break
        return {k: torch.stack(v).numpy() for k, v in rec.items()}

    return episode


def dashboard_frames(tr: dict, model, device) -> list:
    """The dashboard's frames of the episode ``tr``: every
    ``max(1, T // 240)``-th step, a 2x2 panel of the step's actions, its
    state rendered at 320x240 with the step and cumulative reward drawn
    on it, the reward, cumulative reward and value curves so far, and
    its obs."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from deepmimic_mujoco_tpu_torch.tools.render import render_state

    frames = []
    T = tr["ep_len"]
    cum = np.cumsum(tr["reward"])
    for i in range(0, T, max(1, T // 240)):   # bound the video's length
        frame = render_state(model, tr["qpos"][i], mode="rgb_array",
                             width=320, height=240,
                             overlay=f"{i:>5} {cum[i]:>8.2f}", device=device)
        fig, ax = plt.subplots(2, 2, num="eval", figsize=(8, 6))
        ax[0, 0].axhline(0, color="black", lw=1)
        ax[0, 0].step(np.arange(tr["action"].shape[1]), tr["action"][i],
                      where="mid")
        ax[0, 0].set_title("actions")
        ax[0, 1].imshow(frame)
        ax[0, 1].axis("off")
        ax[1, 0].plot(cum[:i + 1], label="ep_rew")
        ax[1, 0].plot(tr["reward"][:i + 1], label="r")
        ax[1, 0].plot(tr["value"][:i + 1], label="V")
        ax[1, 0].legend(fontsize=6)
        ax[1, 1].step(np.arange(tr["obs"].shape[1]), tr["obs"][i],
                      where="mid")
        ax[1, 1].set_title("obs")
        fig.canvas.draw()
        buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
        w, h = fig.canvas.get_width_height()
        frames.append(buf.reshape(h, w, 4)[..., :3].copy())
        plt.close(fig)
    return frames


def _plot_log(log, video_dir):
    """rew_plot.png and len_plot.png of the CSV log (reference:
    src/sb3_ppo.py:101-126)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for col, name in [(2, "rew_plot.png"), (1, "len_plot.png")]:
        fig, ax = plt.subplots(1, 1)
        ax.plot(log[:, 0], log[:, col])
        ax.set_xlabel("Global Step")
        fig.savefig(os.path.join(video_dir, name))
        plt.close(fig)


def eval_dashboard_rollout(ppo, net, n: int, run_name: str,
                           out_dir: str = "~/deep_mimic",
                           render: bool = True, max_steps: int = 1000,
                           metrics_cb=None,
                           plots: Optional[bool] = None) -> dict:
    """Rollout, dashboard video (with ``render``), plots (with ``plots``;
    None: with ``render``), CSV episode log and best-checkpoint save,
    like the reference's eval_dashboard_rollout."""
    # acyclic (getup) clips are evaluated from frame 0, like the
    # reference's play scripts; cyclic motions keep RSI starts
    idx0 = 0 if getattr(ppo.env, "is_acyclical", False) else None
    tr = eval_rollout(ppo, net, max_steps=max_steps, idx_init=idx0)
    video_dir = os.path.expanduser(os.path.join(out_dir, run_name + "_videos"))
    os.makedirs(video_dir, exist_ok=True)
    if render:
        from deepmimic_mujoco_tpu_torch.tools.render import frames_to_video

        video_path = os.path.join(video_dir, f"global_step_{n}.mp4")
        frames_to_video(dashboard_frames(tr, ppo.env.model, ppo.env.device),
                        video_path)
        print("Saved video to", video_path)
    log_path = os.path.join(video_dir, "log.csv")
    if not os.path.exists(log_path):
        with open(log_path, "w") as f:
            f.write("global_step,ep_len,ep_rew\n")
    with open(log_path, "a") as f:
        f.write(f"{n},{tr['ep_len']},{tr['ep_rew']}\n")
    log = np.loadtxt(log_path, delimiter=",", skiprows=1).reshape(-1, 3)
    if (render if plots is None else plots):
        _plot_log(log, video_dir)
    if metrics_cb is not None:
        metrics_cb({
            "eval_episode_length": tr["ep_len"],
            "eval_episode_reward": tr["ep_rew"],
            "eval_global_step": n,
            "eval_best_episode_reward": float(log[:, 2].max()),
        })
    # best-checkpoint saving (reference: src/sb3_ppo.py:137-138), plus an
    # always-current snapshot
    if log[:, 2].max() == log[-1, 2]:
        checkpoint.save_params(
            os.path.join(video_dir, run_name + "_best.pt"), net)
    checkpoint.save_params(
        os.path.join(video_dir, run_name + "_latest.pt"), net)
    print(f"Eval: LEN {tr['ep_len']}, EP_REW {tr['ep_rew']:.2f}")
    return tr


class ThreadedEvaluator:
    """Runs eval jobs on a daemon worker thread against a frozen params
    copy (the reference's EvalDashboardCallbackThreaded). A failed eval
    never stops training: its exception is kept in ``errors`` for the
    caller to raise once training is done."""

    def __init__(self, ppo, run_name: str, out_dir: str = "~/deep_mimic",
                 render: bool = True, metrics_cb=None):
        self.ppo = ppo
        self.run_name = run_name
        self.out_dir = out_dir
        self.render = render
        self.metrics_cb = metrics_cb
        self.errors = []
        self._net = ppo.make_net()
        self._q = queue.Queue(maxsize=1)
        self._busy = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            job = self._q.get()
            if job is None:       # shutdown sentinel (see stop())
                return
            params, n, render = job
            try:
                self._net.load_state_dict(params)
                eval_dashboard_rollout(self.ppo, self._net, n, self.run_name,
                                       out_dir=self.out_dir, render=render,
                                       metrics_cb=self.metrics_cb,
                                       plots=self.render)
            except Exception as e:  # eval must never kill training
                self.errors.append(e)
                print("Eval worker error:", repr(e))
            finally:
                self._busy.clear()

    def queue_eval(self, net, n: int, wait: bool = True,
                   render: Optional[bool] = None):
        """Queue an eval of a frozen copy of ``net``'s params at global
        step ``n``; ``wait`` first lets a running eval finish.
        ``render=None`` takes the evaluator's default. Drawing the
        dashboard holds the GIL (matplotlib), so a training loop renders
        the video of only some of its evals; the plots follow the
        evaluator's default at every eval."""
        if wait:
            while self._busy.is_set():
                time.sleep(0.2)
        frozen = {k: v.detach().clone() for k, v in net.state_dict().items()}
        self._busy.set()
        self._q.put((frozen, n, self.render if render is None else render))

    def stop(self, wait: bool = True):
        """Drain and join the worker."""
        if wait:
            while self._busy.is_set():
                time.sleep(0.2)
        self._q.put(None)
        self._thread.join(timeout=600)
