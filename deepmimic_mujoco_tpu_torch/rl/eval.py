"""Evaluation: a deterministic episode, its CSV log and best-params save,
and a worker thread that runs evaluations beside training.

The port of the JAX package's ``rl/eval.py``. The episode runs one env
under the policy's mean action until it is done: the JAX package runs
a fixed-length scan with the carry frozen and the reward masked after
that (as the gate tests mask it), which gives the same trajectory. The
dashboard video and its plots wait for the render port (ROADMAP Queue 1
item 7); until then the training CLI refuses to render.
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


def eval_dashboard_rollout(ppo, net, n: int, run_name: str,
                           out_dir: str = "~/deep_mimic",
                           max_steps: int = 1000, metrics_cb=None) -> dict:
    """Rollout, CSV episode log and best-checkpoint save, like the
    reference's eval_dashboard_rollout (without its video and plots)."""
    # acyclic (getup) clips are evaluated from frame 0, like the
    # reference's play scripts; cyclic motions keep RSI starts
    idx0 = 0 if getattr(ppo.env, "is_acyclical", False) else None
    tr = eval_rollout(ppo, net, max_steps=max_steps, idx_init=idx0)
    video_dir = os.path.expanduser(os.path.join(out_dir, run_name + "_videos"))
    os.makedirs(video_dir, exist_ok=True)
    log_path = os.path.join(video_dir, "log.csv")
    if not os.path.exists(log_path):
        with open(log_path, "w") as f:
            f.write("global_step,ep_len,ep_rew\n")
    with open(log_path, "a") as f:
        f.write(f"{n},{tr['ep_len']},{tr['ep_rew']}\n")
    log = np.loadtxt(log_path, delimiter=",", skiprows=1).reshape(-1, 3)
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
                 metrics_cb=None):
        self.ppo = ppo
        self.run_name = run_name
        self.out_dir = out_dir
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
            params, n = job
            try:
                self._net.load_state_dict(params)
                eval_dashboard_rollout(self.ppo, self._net, n, self.run_name,
                                       out_dir=self.out_dir,
                                       metrics_cb=self.metrics_cb)
            except Exception as e:  # eval must never kill training
                self.errors.append(e)
                print("Eval worker error:", repr(e))
            finally:
                self._busy.clear()

    def queue_eval(self, net, n: int, wait: bool = True):
        """Queue an eval of a frozen copy of ``net``'s params at global
        step ``n``; ``wait`` first lets a running eval finish."""
        if wait:
            while self._busy.is_set():
                time.sleep(0.2)
        frozen = {k: v.detach().clone() for k, v in net.state_dict().items()}
        self._busy.set()
        self._q.put((frozen, n))

    def stop(self, wait: bool = True):
        """Drain and join the worker."""
        if wait:
            while self._busy.is_set():
                time.sleep(0.2)
        self._q.put(None)
        self._thread.join(timeout=600)
