"""DeepMimic imitation reward, batch-major.

r = wp*exp(-(sum|dq| + |dpitch|)) + wv*exp(-0.1*sum|dqvel|)
  + we*exp(-40*sum||d_ee||^2) + wc*exp(-10*||d_com||^2) + wj*qlim_frac

with the reference's weights wp=.75 wv=.1 we=.15 wc=0 wj=-.1 and its
G1-specific joint subsets (reference: src/deepmimic_env.py:193-256,
weights at :400-404). The CoM term uses body frame origins weighted by
body mass, exactly like the reference's use of ``body_xpos``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from deepmimic_mujoco_tpu_torch.envs.spec import RobotSpec
from deepmimic_mujoco_tpu_torch.utils import quat as tq

DEFAULT_WEIGHTS = dict(wp=0.75, wv=0.1, we=0.15, wc=0.0, wj=-0.1)


class RewardInfo(NamedTuple):
    reward: torch.Tensor
    reward_config: torch.Tensor
    reward_qvel: torch.Tensor
    reward_end_eff: torch.Tensor
    reward_com: torch.Tensor
    reward_joint_limit: torch.Tensor
    curr_root_roll: torch.Tensor
    target_root_roll: torch.Tensor
    curr_root_pitch: torch.Tensor
    target_root_pitch: torch.Tensor
    config_angle_diffs: torch.Tensor


def make_reward_tables(m, spec: RobotSpec):
    """Static arrays used by the reward: masses, joint-limit box."""
    jnt_tol = np.asarray(m.jnt_range)[1:] * 0.99  # reference's 0.99 trick
    jnt_tol = jnt_tol[spec.qpos_idx - 7]
    return dict(
        body_mass=np.asarray(m.body_mass),
        jnt_lo=jnt_tol[:, 0],
        jnt_hi=jnt_tol[:, 1],
        ee_geoms=np.asarray(spec.ee_geoms, np.int32),
        qpos_idx=np.asarray(spec.qpos_idx),
        qvel_idx=np.asarray(spec.qvel_idx),
    )


def device_tables(tables, device):
    """``make_reward_tables``'s arrays as tensors on ``device`` (masses
    and limits float32, indices int64), so a step's reward copies
    nothing from the host."""
    floats = ("body_mass", "jnt_lo", "jnt_hi")
    return {k: torch.as_tensor(np.asarray(v), device=device,
                               dtype=torch.float32 if k in floats
                               else torch.int64)
            for k, v in tables.items()}


def calc_imitation_reward(tables, qpos, qvel, geom_xpos, body_xpos,
                          mocap_qpos, mocap_qvel, mocap_geom_xpos,
                          mocap_body_xpos,
                          wp=0.75, wv=0.1, we=0.15, wc=0.0, wj=-0.1
                          ) -> RewardInfo:
    """Every state argument carries a leading env axis; ``tables`` holds
    ``make_reward_tables``'s arrays, as numpy arrays or as tensors on
    the state's device (``device_tables``)."""
    dev, dt = qpos.device, qpos.dtype
    qpos_idx = tables["qpos_idx"]
    qvel_idx = tables["qvel_idx"]

    # joint configuration + root pitch
    diffs = torch.abs(qpos[:, qpos_idx] - mocap_qpos[:, qpos_idx])
    err_configs = diffs.sum(-1)
    curr_rpy = tq.to_rpy(qpos[:, 3:7])
    tgt_rpy = tq.to_rpy(mocap_qpos[:, 3:7])
    err_pitch = torch.abs(curr_rpy[:, 1] - tgt_rpy[:, 1])
    reward_config = torch.exp(-(err_configs + err_pitch))

    # joint velocity
    err_qvel = torch.abs(qvel[:, qvel_idx] - mocap_qvel[:, qvel_idx]).sum(-1)
    reward_qvel = torch.exp(-0.1 * err_qvel)

    # end effectors
    ee = tables["ee_geoms"]
    d_ee = geom_xpos[:, ee] - mocap_geom_xpos[:, ee]
    reward_end_eff = torch.exp(-40.0 * (d_ee ** 2).sum((-1, -2)))

    # center of mass (body frame origins, mass weighted)
    mass = torch.as_tensor(tables["body_mass"], dtype=dt, device=dev)[:, None]
    com = (body_xpos * mass).sum(-2) / mass.sum()
    tgt_com = (mocap_body_xpos * mass).sum(-2) / mass.sum()
    reward_com = torch.exp(-10.0 * ((com - tgt_com) ** 2).sum(-1))

    # joint-limit violation fraction
    q = qpos[:, qpos_idx]
    lo = torch.as_tensor(tables["jnt_lo"], dtype=dt, device=dev)
    hi = torch.as_tensor(tables["jnt_hi"], dtype=dt, device=dev)
    qlim = ((q <= lo) | (q >= hi)).to(dt).mean(-1)

    reward = (wp * reward_config + wv * reward_qvel + we * reward_end_eff
              + wc * reward_com + wj * qlim)
    return RewardInfo(
        reward=reward, reward_config=reward_config, reward_qvel=reward_qvel,
        reward_end_eff=reward_end_eff, reward_com=reward_com,
        reward_joint_limit=qlim,
        curr_root_roll=curr_rpy[:, 0], target_root_roll=tgt_rpy[:, 0],
        curr_root_pitch=curr_rpy[:, 1], target_root_pitch=tgt_rpy[:, 1],
        config_angle_diffs=diffs,
    )
