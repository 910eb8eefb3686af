"""Static env specialization: name lookups resolved to id arrays once.

The reference resolves geom/body names per step with string matching
inside the hot loop (src/deepmimic_env.py:88-101, :161); here all ids
are compile-time constants.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from reference.envs.config import RobotConfig
from reference.models.physics_model import PhysicsModel


@dataclasses.dataclass(frozen=True)
class RobotSpec:
    robot: str
    torso_body: int
    lfoot_geom: int
    rfoot_geom: int
    floor_geom: int
    extra_contact_geoms: tuple   # ids, possibly empty
    ee_geoms: tuple              # end-effector geom ids
    low_z: float
    n_hand_actions: int          # trailing zero-filled ctrl dims (G1: 14)
    act_scale: float             # action multiplier (G1: 20)
    # reward index sets (reference: src/deepmimic_env.py:204-211)
    qpos_idx: np.ndarray         # joints used for config error
    qvel_idx: np.ndarray

    @staticmethod
    def build(m: PhysicsModel, rc: RobotConfig) -> "RobotSpec":
        if rc.robot == "unitree_g1":
            qpos_idx = np.array([7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
                                 18, 19, 20, 21, 22, 23, 24, 32, 33, 34,
                                 35, 36])
            qvel_idx = qpos_idx - 1
            n_hand, act_scale = 14, 20.0
        else:
            qpos_idx = np.arange(7, m.nq)
            qvel_idx = np.arange(6, m.nv)
            n_hand, act_scale = 0, 1.0
        extra = tuple(m.geom_name2id(n)
                      for n in (rc.extra_contact_geom_names or []))
        return RobotSpec(
            robot=rc.robot,
            torso_body=m.body_name2id(rc.torso_body_name),
            lfoot_geom=m.geom_name2id(rc.lfoot_geom_name),
            rfoot_geom=m.geom_name2id(rc.rfoot_geom_name),
            floor_geom=m.geom_name2id(rc.floor_geom_name),
            extra_contact_geoms=extra,
            ee_geoms=tuple(m.geom_name2id(n)
                           for n in rc.endeffector_geom_names),
            low_z=rc.low_z,
            n_hand_actions=n_hand,
            act_scale=act_scale,
            qpos_idx=qpos_idx,
            qvel_idx=qvel_idx,
        )
