"""Observation library, batch-major.

Mirrors the reference's observation composition (reference:
src/deepmimic_env.py:33-191): qpos[7:], scaled qvel[6:], torso RPY +
yaw-aligned body-frame velocities, foot/extra floor-contact flags,
joint forces, absolute geom positions and phase. The player-action
encoding belongs to the combined env, a later slice of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from deepmimic_mujoco_tpu_torch.envs.spec import RobotSpec
from deepmimic_mujoco_tpu_torch.physics.collision import Contacts
from deepmimic_mujoco_tpu_torch.physics.step import EngineData
from deepmimic_mujoco_tpu_torch.utils import quat as tq


def _contact_flag(contacts: Contacts, geom_ids, floor_geom: int):
    """(B,) 1.0 when any active contact joins one of geom_ids to the
    floor."""
    active = contacts.dist < contacts.includemargin
    ids = torch.as_tensor(np.asarray(geom_ids, np.int64),
                          device=contacts.geom1.device)
    in_set1 = torch.isin(contacts.geom1, ids)
    in_set2 = torch.isin(contacts.geom2, ids)
    floor1 = contacts.geom1 == floor_geom
    floor2 = contacts.geom2 == floor_geom
    hit = active & ((in_set1 & floor2) | (in_set2 & floor1))
    return hit.any(-1).to(contacts.dist.dtype)


def get_torso_obs(spec: RobotSpec, data: EngineData, scale: float):
    b = spec.torso_body
    rpy = tq.to_rpy(data.kin.xquat[:, b])
    vel_lin = data.cvel[:, b, 3:]
    vel_rot = data.cvel[:, b, :3]
    yaw = rpy[:, 2]
    c, s = torch.cos(-yaw), torch.sin(-yaw)
    vx = c * vel_lin[:, 0] - s * vel_lin[:, 1]
    vy = s * vel_lin[:, 0] + c * vel_lin[:, 1]
    vz = vel_lin[:, 2]
    return torch.stack([rpy[:, 0], rpy[:, 1], vx, vy, vz, vel_rot[:, 0],
                        vel_rot[:, 1], vel_rot[:, 2]], -1) * scale


def get_obs(m, spec: RobotSpec, cfg, data: EngineData, qpos, qvel,
            idx_curr, motion_len) -> torch.Tensor:
    if cfg.ADD_PLAYER_ACTION_OBS:
        raise NotImplementedError(
            "player-action observations come with the combined env")
    parts = [qpos[:, 7:], qvel[:, 6:] * cfg.VEL_OBS_SCALE]
    if cfg.ADD_TORSO_OBS:
        parts.append(get_torso_obs(spec, data, cfg.VEL_OBS_SCALE))
    if cfg.ADD_FOOT_CONTACT_OBS:
        parts.append(torch.stack([
            _contact_flag(data.contacts, [spec.rfoot_geom], spec.floor_geom),
            _contact_flag(data.contacts, [spec.lfoot_geom], spec.floor_geom),
        ], -1))
    if cfg.ADD_EXTRA_CONTACT_OBS:
        parts.append(torch.stack([
            _contact_flag(data.contacts, [g], spec.floor_geom)
            for g in spec.extra_contact_geoms], -1))
    if cfg.ADD_JOINT_FORCE_OBS:
        parts.append((data.qfrc_smooth + data.qfrc_constraint)
                     * cfg.FRC_OBS_SCALE)
    if cfg.ADD_ABSPOS_OBS:
        parts.append(data.kin.geom_xpos.reshape(qpos.shape[0], -1))
    if cfg.ADD_PHASE_OBS:
        phase = torch.clamp(idx_curr.to(qpos.dtype) / motion_len, 0.0, 1.0)
        parts.append(phase[:, None])
    return torch.cat(parts, -1)


def obs_size(m, spec: RobotSpec, cfg) -> int:
    n = (m.nq - 7) + (m.nv - 6)
    if cfg.ADD_TORSO_OBS:
        n += 8
    if cfg.ADD_FOOT_CONTACT_OBS:
        n += 2
    if cfg.ADD_EXTRA_CONTACT_OBS:
        n += len(spec.extra_contact_geoms)
    if cfg.ADD_JOINT_FORCE_OBS:
        n += m.nv
    if cfg.ADD_ABSPOS_OBS:
        n += 3 * m.ngeom
    if cfg.ADD_PHASE_OBS:
        n += 1
    if cfg.ADD_PLAYER_ACTION_OBS:
        n += 2 + cfg.MAX_PLAYER_ACTIONS + 2
    return n
