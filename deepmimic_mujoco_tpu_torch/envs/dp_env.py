"""Single-motion imitation env (DPEnv), batch-major torch.

Functionally equivalent to the reference's DPEnv (reference:
src/deepmimic_env.py:273-538) — torque control, DeepMimic imitation
reward, reference-state initialization (RSI), early termination and the
divergence / obs-out-of-bounds guard — as functions of an explicit
batched state:

    state', out = env.step(state, action)

Every state field carries a leading env axis. Random draws (RSI frames)
come from a ``torch.Generator`` the caller passes in. Under data
parallelism (``parallel/mesh.py``) a rank holds a slice of the env batch
and passes its ``shard``: each draw is then the global batch's draw,
sliced, so the sharded envs draw what the unsharded batch would.

Divergence handling: non-finite state or |obs| > 100 zeroes the
observation and terminates with a machine-readable done_reason.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepmimic_mujoco_tpu_torch.envs import obs as obs_lib
from deepmimic_mujoco_tpu_torch.envs import reward as reward_lib
from deepmimic_mujoco_tpu_torch.envs.config import (
    DPEnvConfig, MotionConfig, RobotConfig,
)
from deepmimic_mujoco_tpu_torch.envs.spec import RobotSpec
from deepmimic_mujoco_tpu_torch.mocap import load_clip
from deepmimic_mujoco_tpu_torch.mocap.loader import resample_clip_speed
from deepmimic_mujoco_tpu_torch.models import load_model
from deepmimic_mujoco_tpu_torch.models.physics_model import EULER
from deepmimic_mujoco_tpu_torch.physics.step import Engine
from deepmimic_mujoco_tpu_torch.utils import tracing

# done_reason codes (info["done_reason"] strings in the reference)
DONE_NONE = 0
DONE_LOW_Z = 1
DONE_HIGH_Z = 2
DONE_RUN_ROLL = 3
DONE_RUN_PITCH = 4
DONE_MAX_EP_LEN = 5
DONE_ACYCLICAL_END = 6
DONE_OBS_OOB = 7

DONE_REASON_NAMES = {
    DONE_NONE: "", DONE_LOW_Z: "low_z", DONE_HIGH_Z: "high_z",
    DONE_RUN_ROLL: "run roll limit", DONE_RUN_PITCH: "run pitch limit",
    DONE_MAX_EP_LEN: "max_ep_len", DONE_ACYCLICAL_END: "acyclical_end",
    DONE_OBS_OOB: "obs_out_of_bounds",
}


class DPEnvState(NamedTuple):
    qpos: torch.Tensor            # (B, nq)
    qvel: torch.Tensor            # (B, nv)
    idx_curr: torch.Tensor        # (B,) int64 current mocap frame
    episode_length: torch.Tensor  # (B,) int64
    episode_reward: torch.Tensor  # (B,) float32
    lam: torch.Tensor             # (B, n_warm_rows) warm-start forces


class StepOut(NamedTuple):
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    done_reason: torch.Tensor     # int64 code
    reward_info: reward_lib.RewardInfo
    # Root planar-velocity match vs the mocap frame, exp(-|dv_xy|); not
    # part of the reference reward, exposed for training-only shaping.
    vel_match: torch.Tensor
    # active contacts dropped by the fixed-slot top-K selection this
    # step (0 = lossless)
    contact_overflow: torch.Tensor


def sharded(draw, n: int, shard=None):
    """``draw(m)`` of the ``m`` rows of the global batch whose ``shard``
    this rank's ``n`` rows are, sliced to them; ``draw(n)`` without a
    shard."""
    if shard is None:
        return draw(n)
    return shard.shard(draw(n * shard.world))


class DPEnv:
    version = "v1.0"

    def __init__(self, motion: Optional[str] = None,
                 robot: str = "humanoid3d",
                 cfg: Optional[DPEnvConfig] = None,
                 max_contacts: Optional[int] = None,
                 iterations: Optional[int] = None,
                 integrator: Optional[int] = None,
                 speed: float = 1.0,
                 warm_start_lam: Optional[bool] = None,
                 mesh_subcapsules: Optional[int] = None,
                 cone: Optional[str] = None,
                 device="cuda"):
        # semi-implicit Euler with implicit joint damping (1 forward per
        # step), the JAX package's training default
        if integrator is None:
            integrator = EULER
        self.ENV_CFG = cfg or DPEnvConfig()
        self.motion_config = MotionConfig(motion=motion, robot=robot)
        self.robot_config = RobotConfig(robot=robot)
        self.model = load_model(self.robot_config.xml_path)
        if max_contacts is None:
            # sized to measured worst-case active contacts (+margin):
            # humanoid3d peaks at ~11 (falls), G1 at ~23 (prone getup)
            max_contacts = 16 if robot == "humanoid3d" else 24
        eng_kw = {k: v for k, v in dict(
            warm_start_lam=warm_start_lam,
            mesh_subcapsules=mesh_subcapsules,
            cone=cone).items() if v is not None}
        self.engine = Engine(self.model, max_contacts=max_contacts,
                             iterations=iterations, integrator=integrator,
                             device=device, **eng_kw)
        self.device = self.engine.device
        self.spec = RobotSpec.build(self.model, self.robot_config)
        self.reward_tables = reward_lib.make_reward_tables(self.model,
                                                           self.spec)
        self._reward_tables_dev = {
            k: (torch.as_tensor(v, dtype=torch.float32, device=self.device)
                if k in ("body_mass", "jnt_lo", "jnt_hi") else v)
            for k, v in self.reward_tables.items()}

        with tracing.setup("setup.mocap"):
            clip = load_clip(self.motion_config.mocap_path, self.model)
            if speed != 1.0:
                clip = resample_clip_speed(clip, speed)
            f32 = lambda a: torch.as_tensor(
                np.asarray(a), dtype=torch.float32, device=self.device)
            self.mocap_qpos = f32(clip.qpos)
            self.mocap_qvel = f32(clip.qvel)
            self.mocap_body_xpos = f32(clip.body_xpos)
            self.mocap_geom_xpos = f32(clip.geom_xpos)
        self.speed = speed
        self.clip = clip
        self.mocap_data_len = len(clip)
        self.mocap_dt = clip.dt
        self._body_mass = f32(self.model.body_mass)[:, None]

        motion_name = self.motion_config.motion
        self.is_floor_motion = motion_name in self.motion_config.floor_motions
        self.is_acyclical = motion_name in self.motion_config.acyclical_motions
        self.check_run_angles = (motion_name == "run"
                                 and robot == "unitree_g1")

        self.action_size = self.model.nu - self.spec.n_hand_actions
        self.obs_size = obs_lib.obs_size(self.model, self.spec, self.ENV_CFG)

    # ---- helpers -------------------------------------------------------
    def _obs(self, data, qpos, qvel, idx_curr):
        return obs_lib.get_obs(self.model, self.spec, self.ENV_CFG, data,
                               qpos, qvel, idx_curr, self.mocap_data_len)

    def _mujoco_action(self, action):
        ctrl = action * self.spec.act_scale
        if self.spec.n_hand_actions:
            ctrl = torch.cat([ctrl, ctrl.new_zeros(
                ctrl.shape[0], self.spec.n_hand_actions)], -1)
        return ctrl

    def _draw_frames(self, n: int, generator):
        return torch.randint(0, self.mocap_data_len, (n,),
                             generator=generator, device=self.device)

    def _fresh_state(self, idx) -> DPEnvState:
        n = idx.shape[0]
        zeros_i = torch.zeros(n, dtype=torch.int64, device=self.device)
        return DPEnvState(
            qpos=self.mocap_qpos[idx], qvel=self.mocap_qvel[idx],
            idx_curr=idx, episode_length=zeros_i,
            episode_reward=torch.zeros(n, dtype=torch.float32,
                                       device=self.device),
            lam=self.engine.empty_lam(n))

    # ---- functional API --------------------------------------------------
    def reset(self, n_envs: int, generator: Optional[torch.Generator] = None,
              idx_init=None, shard=None) -> Tuple[DPEnvState, torch.Tensor]:
        """Reference-state initialization of ``n_envs`` envs: random clip
        frames drawn from ``generator`` (with a ``shard``, this rank's
        slice of the global batch's draw), or the forced frame(s)
        ``idx_init`` (an int for all envs, or one per env)
        (reference: src/deepmimic_env.py:312-316, :502-510)."""
        if idx_init is None:
            idx = sharded(lambda m: self._draw_frames(m, generator), n_envs,
                          shard)
        else:
            idx = torch.as_tensor(idx_init, dtype=torch.int64,
                                  device=self.device)
            idx = idx.expand(n_envs).clone()
            if bool(((idx < 0) | (idx >= self.mocap_data_len)).any()):
                raise ValueError(f"idx_init outside the clip's "
                                 f"{self.mocap_data_len} frames")
        state = self._fresh_state(idx)
        data = self.engine.data_view(state.qpos, state.qvel)
        return state, self._obs(data, state.qpos, state.qvel, idx)

    def step(self, state: DPEnvState, action: torch.Tensor,
             force_state=None) -> Tuple[DPEnvState, StepOut]:
        """One env step. ``force_state=(qpos, qvel)`` bypasses the
        dynamics: the state is set and the fields are FRESH at it, like
        the reference's set_state + forward; its ``lam`` is the empty
        warm start."""
        with tracing.span("env.physics"):
            if force_state is not None:
                qpos, qvel = force_state
                data = self.engine.data_view(qpos, qvel)
            else:
                # derived fields (FK, contacts, cvel, forces) come from
                # the step's own forward pass at the PRE-integration
                # state — the reference's post-``mj_step`` staleness
                # semantics
                ctrl = self._mujoco_action(action)
                qpos, qvel, data = self.engine.step(state.qpos, state.qvel,
                                                   ctrl, lam0=state.lam)

        with tracing.span("env.obs"):
            obs = self._obs(data, qpos, qvel, state.idx_curr)

        idx = state.idx_curr
        with tracing.span("env.reward"):
            rew = reward_lib.calc_imitation_reward(
                self._reward_tables_dev, qpos, qvel, data.kin.geom_xpos,
                data.kin.xpos, self.mocap_qpos[idx], self.mocap_qvel[idx],
                self.mocap_geom_xpos[idx], self.mocap_body_xpos[idx])
        with tracing.span("env.done"):
            # ---- termination (reference: src/deepmimic_env.py:418-442) ----
            B = qpos.shape[0]
            done = torch.zeros(B, dtype=torch.bool, device=self.device)
            reason = torch.zeros(B, dtype=torch.int64, device=self.device)
            if not self.is_floor_motion:
                mass = self._body_mass
                z_com = ((data.kin.xipos * mass).sum(-2) / mass.sum())[:, 2]
                low = z_com < self.spec.low_z
                high = z_com > 2.0
                done = done | low | high
                reason = torch.where(low, DONE_LOW_Z,
                                     torch.where(high, DONE_HIGH_Z, reason))
            if self.check_run_angles:
                max_angle = float(np.deg2rad(60.0))
                roll_bad = torch.abs(rew.curr_root_roll
                                     - rew.target_root_roll) > max_angle
                pitch_bad = torch.abs(rew.curr_root_pitch
                                      - rew.target_root_pitch) > max_angle
                reason = torch.where(roll_bad & ~done, DONE_RUN_ROLL, reason)
                reason = torch.where(pitch_bad & ~done & ~roll_bad,
                                     DONE_RUN_PITCH, reason)
                done = done | roll_bad | pitch_bad
            if self.ENV_CFG.MAX_EP_LENGTH:
                over = state.episode_length >= self.ENV_CFG.MAX_EP_LENGTH
                reason = torch.where(over & ~done, DONE_MAX_EP_LEN, reason)
                done = done | over
            if self.is_acyclical:
                end = (idx + 1) == self.mocap_data_len
                reason = torch.where(end & ~done, DONE_ACYCLICAL_END, reason)
                done = done | end

            # divergence / obs out of bounds guard (reference :465-476)
            bad = ((~torch.isfinite(obs).all(-1))
                   | (torch.abs(obs).amax(-1) > 100.0)
                   | (~torch.isfinite(qpos).all(-1))
                   | (~torch.isfinite(qvel).all(-1)))
            obs = torch.where(bad[:, None], 0.0, obs)
            reward = torch.where(bad, 0.0, rew.reward)
            reason = torch.where(bad, DONE_OBS_OOB, reason)
            done = done | bad

            # guard state against NaN poisoning the episode after auto-reset
            qpos = torch.where(torch.isfinite(qpos), qpos, 0.0)
            qvel = torch.where(torch.isfinite(qvel), qvel, 0.0)

        new_state = DPEnvState(
            qpos=qpos, qvel=qvel,
            idx_curr=(idx + 1) % self.mocap_data_len,
            episode_length=state.episode_length + 1,
            episode_reward=state.episode_reward + reward,
            lam=data.lam)
        dv = qvel[:, :2] - self.mocap_qvel[idx][:, :2]
        vel_match = torch.exp(-torch.sqrt((dv * dv).sum(-1) + 1e-12))
        out = StepOut(obs=obs, reward=reward, done=done,
                      done_reason=reason, reward_info=rew,
                      vel_match=vel_match,
                      contact_overflow=data.contacts.overflow)
        return new_state, out

    @tracing.spanned("env.step")
    def step_auto_reset(self, state: DPEnvState, action: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        shard=None) -> Tuple[DPEnvState, StepOut]:
        """Training step: on done, the next state is a fresh RSI reset at
        a frame drawn from ``generator`` (the obs returned is the
        terminal obs, matching SB3 vec-env accounting); with a ``shard``,
        at this rank's slice of the global batch's draw."""
        new_state, out = self.step(state, action)
        with tracing.span("env.reset"):
            reset_state = self._fresh_state(sharded(
                lambda m: self._draw_frames(m, generator), out.done.shape[0],
                shard))
            d = out.done
            picked = DPEnvState(*[
                torch.where(d.view((-1,) + (1,) * (a.dim() - 1)), a, b)
                for a, b in zip(reset_state, new_state)])
        return picked, out
