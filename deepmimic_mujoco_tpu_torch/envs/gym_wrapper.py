"""Host-facing single-env wrappers with the reference's gym-style API.

The port of the JAX package's ``envs/gym_wrapper.py``: ``reset()``,
``reset_model(idx_init)`` and ``step(action, force_state=None)``
returning ``(obs, reward, done, info)`` with the reward components and
``done_reason`` in ``info`` (reference: src/deepmimic_env.py:273-538),
over a batch of one of the port's functional envs, on the card by
default. ``GymDPEnv`` keeps the episode debug log and writes the JSON
crash dump on divergence (src/deepmimic_env.py:366-378, :457-476).

These wrappers are for interactive use, playback and tools (one host
round trip a step); training runs on the batched functional API.
``render`` draws the state with ``tools/render.py`` (FK on the env's
device, the ray tracer on the host), with the JAX package's overlays.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from deepmimic_mujoco_tpu_torch.envs.combined_env import (
    DONE_FALLEN_NO_AMNESTY, MOTION_NAMES, DPCombinedEnv,
)
from deepmimic_mujoco_tpu_torch.envs.dp_env import DONE_REASON_NAMES, DPEnv

class Box(NamedTuple):
    low: np.ndarray
    high: np.ndarray

    @property
    def shape(self):
        return self.low.shape

    def sample(self, rng=np.random):
        return rng.uniform(self.low, self.high)


def _unbounded(n):
    return Box(low=np.full(n, -np.inf, np.float32),
               high=np.full(n, np.inf, np.float32))


class _Single:
    """What both wrappers share: a state of batch 1 and the host
    conversions around it."""

    def _batch(self, x):
        return torch.as_tensor(np.asarray(x, np.float32),
                               device=self.env.device)[None]

    def _force(self, force_state):
        if force_state is None:
            return None
        q, v = force_state
        return self._batch(q), self._batch(v)

    def _step(self, action, force_state):
        with torch.no_grad():
            self._state, out = self.env.step(
                self._state, self._batch(action),
                force_state=self._force(force_state))
        return out

    @property
    def episode_reward(self):
        return (float(self._state.episode_reward[0])
                if self._state is not None else 0.0)

    @property
    def episode_length(self):
        return (int(self._state.episode_length[0])
                if self._state is not None else 0)

    def _render(self, mode, overlay):
        from deepmimic_mujoco_tpu_torch.tools.render import render_state

        return render_state(self.model, self._state.qpos[0], mode=mode,
                            overlay=overlay, device=self.env.device)

    def close(self):
        pass


class GymDPEnv(_Single):
    def __init__(self, motion: Optional[str] = None,
                 robot: str = "humanoid3d", seed: int = 0,
                 crash_dump_dir: Optional[str] = None, device="cuda",
                 **kwargs):
        self.env = DPEnv(motion=motion, robot=robot, device=device, **kwargs)
        self.version = self.env.version
        self.ENV_CFG = self.env.ENV_CFG
        self.model = self.env.model
        self.mocap = self.env.clip
        self.mocap_data_len = self.env.mocap_data_len
        self.crash_dump_dir = crash_dump_dir or tempfile.gettempdir()
        self._gen = torch.Generator(device=self.env.device).manual_seed(seed)
        self._state = None

        # reference DPEnv: raw ctrlrange of the first N motors (hand
        # motors dropped), NOT scaled (src/deepmimic_env.py:305-307)
        n = self.env.action_size
        cr = np.asarray(self.model.actuator_ctrlrange, np.float32)[:n]
        self.action_space = Box(low=cr[:, 0].copy(), high=cr[:, 1].copy())
        self.observation_space = _unbounded(self.env.obs_size)
        self.episode_debug_log = {}

    # ---- reference-compatible properties -------------------------------
    @property
    def idx_curr(self):
        return int(self._state.idx_curr[0]) if self._state is not None else -1

    @property
    def sim_qpos(self):
        return self._state.qpos[0].cpu().numpy()

    @property
    def sim_qvel(self):
        return self._state.qvel[0].cpu().numpy()

    # ---- API ------------------------------------------------------------
    def reset(self):
        self.episode_debug_log = {}
        return self.reset_model()

    def reset_model(self, idx_init: Optional[int] = None):
        """A fresh episode at frame ``idx_init``, or at a frame drawn
        from the wrapper's generator (seeded by ``seed``)."""
        with torch.no_grad():
            self._state, obs = self.env.reset(1, generator=self._gen,
                                              idx_init=idx_init)
        return obs[0].cpu().numpy()

    def step(self, action, force_state=None):
        out = self._step(action, force_state)
        obs = out.obs[0].cpu().numpy()
        reward = float(out.reward[0])
        done = bool(out.done[0])
        ri = out.reward_info
        info = {k: float(getattr(ri, k)[0]) for k in (
            "reward_config", "reward_qvel", "reward_end_eff", "reward_com",
            "reward_joint_limit")}
        reason = DONE_REASON_NAMES[int(out.done_reason[0])]
        if reason:
            info["done_reason"] = reason

        # episode debug log (reference: src/deepmimic_env.py:457-463)
        log = self.episode_debug_log
        log.setdefault("action", []).append(np.asarray(action).tolist())
        log.setdefault("qpos", []).append(self.sim_qpos.tolist())
        log.setdefault("qvel", []).append(self.sim_qvel.tolist())
        log.setdefault("reward", []).append(reward)

        if reason == "obs_out_of_bounds":
            self._write_crash_dump("Observation out of bounds or "
                                   "simulation divergence")
        return obs, reward, done, info

    def goto(self, qpos):
        """Force qpos with zero velocity (reference:
        src/deepmimic_env.py:489)."""
        self._state = self._state._replace(
            qpos=self._batch(qpos),
            qvel=torch.zeros(1, self.model.nv, device=self.env.device))

    def get_time(self):
        return self.episode_length * self.env.engine.dt

    def render(self, mode=None):
        return self._render(mode, f"{self.episode_length:>5} "
                                  f"{self.episode_reward:>7.2f}")

    # ---- crash forensics -------------------------------------------------
    def _write_crash_dump(self, message):
        path = os.path.join(self.crash_dump_dir, "deepmimic_episode_{}.json"
                            .format(time.strftime("%Y%m%d-%H%M_%S")))
        self.episode_debug_log["full_traceback"] = message
        self.episode_debug_log["motion"] = self.env.motion_config.motion
        self.episode_debug_log["robot"] = self.env.robot_config.robot
        with open(path, "w") as f:
            json.dump(self.episode_debug_log, f, indent=4)
        print(f"Divergence detected, debug log written to {path}")
        return path


class GymDPCombinedEnv(_Single):
    """Host-facing wrapper for the combined env, mirroring the
    reference's DPCombinedEnv gym surface (reset/step, imitation and
    task rewards in info; src/combined_env.py:102-533)."""

    def __init__(self, seed: int = 0, device="cuda", **kwargs):
        self.env = DPCombinedEnv(device=device, **kwargs)
        self.version = self.env.version
        self.ENV_CFG = self.env.ENV_CFG
        self.model = self.env.model
        self._gen = torch.Generator(device=self.env.device).manual_seed(seed)
        self._state = None
        # reference combined env: ctrlrange / ACT_SCALE
        # (src/combined_env.py:196-200)
        n = self.env.action_size
        cr = np.asarray(self.model.actuator_ctrlrange, np.float32)[:n]
        s = self.ENV_CFG.ACT_SCALE
        self.action_space = Box(low=cr[:, 0] / s, high=cr[:, 1] / s)
        self.observation_space = _unbounded(self.env.obs_size)

    @property
    def current_motion_name(self):
        return MOTION_NAMES[int(self._state.motion_id[0])]

    def reset(self):
        with torch.no_grad():
            self._state, obs = self.env.reset(1, generator=self._gen)
        return obs[0].cpu().numpy()

    def get_current_motion_state(self):
        q, v = self.env.get_current_motion_state(self._state)
        return q[0].cpu().numpy(), v[0].cpu().numpy()

    def step(self, action, force_state=None):
        out = self._step(action, force_state)
        info = {"imitation_reward": float(out.imitation_reward[0]),
                "task_reward": float(out.task_reward[0])}
        code = int(out.done_reason[0])
        reason = DONE_REASON_NAMES.get(code)
        if code == DONE_FALLEN_NO_AMNESTY:
            reason = "fallen without amnesty"
        if reason:
            info["done_reason"] = reason
        return (out.obs[0].cpu().numpy(), float(out.reward[0]),
                bool(out.done[0]), info)

    def render(self, mode=None):
        return self._render(mode, f"{self.current_motion_name[-8:]} "
                                  f"{self.episode_length:>5} "
                                  f"{self.episode_reward:>7.2f}")
