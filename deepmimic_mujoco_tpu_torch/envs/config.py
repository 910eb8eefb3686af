"""Env configuration objects (reference: src/config.py:3-49,
src/deepmimic_env.py:258-270). The combined env's config comes with the
combined env, in a later slice of the port.

Path resolution goes through :mod:`deepmimic_mujoco_tpu_torch.models.assets`
(env var ``DM_TPU_ASSET_ROOT``) instead of the reference's hardcoded
``~/Code/DeepMimic_mujoco/src``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from deepmimic_mujoco_tpu_torch.models import assets


@dataclasses.dataclass
class RobotConfig:
    robot: str = "humanoid3d"

    def __post_init__(self):
        if self.robot == "humanoid3d":
            self.torso_body_name = "chest"  # x is forward
            self.lfoot_geom_name = "left_ankle"
            self.rfoot_geom_name = "right_ankle"
            self.floor_geom_name = "floor"
            self.extra_contact_geom_names = None
            self.endeffector_geom_names = [
                "left_ankle", "right_ankle", "left_wrist", "right_wrist"]
            self.low_z = 0.7
        elif self.robot == "unitree_g1":
            self.torso_body_name = "pelvis"  # x is forward
            self.lfoot_geom_name = "left_foot"
            self.rfoot_geom_name = "right_foot"
            self.floor_geom_name = "floor"
            self.extra_contact_geom_names = [
                "left_foot_lheel", "left_foot_rheel", "left_foot_ltoe",
                "left_foot_rtoe", "right_foot_lheel", "right_foot_rheel",
                "right_foot_ltoe", "right_foot_rtoe"]
            self.endeffector_geom_names = [
                "left_foot", "right_foot", "left_hand", "right_hand"]
            self.low_z = 0.4
        else:
            raise ValueError(f"Unknown robot: {self.robot}")
        self.env_name = "deepmimic_" + self.robot
        self.xml_path = assets.xml_path(self.robot)


@dataclasses.dataclass
class MotionConfig:
    motion: Optional[str] = None
    robot: str = "humanoid3d"

    all_motions: Tuple[str, ...] = (
        "backflip", "cartwheel", "crawl", "dance_a", "dance_b",
        "getup_facedown", "getup_faceup", "jump", "kick", "punch",
        "roll", "run", "spin", "spinkick", "walk")
    acyclical_motions: Tuple[str, ...] = (
        "getup_faceup", "getup_facedown", "getup_facedown_slow",
        "getup_facedown_slow_FSI", "getup_facedown_towalk")
    floor_motions: Tuple[str, ...] = (
        "getup_faceup", "getup_facedown", "getup_facedown_slow",
        "getup_facedown_slow_FSI", "getup_facedown_towalk")

    def __post_init__(self):
        if self.motion is None:
            self.motion = "walk"
        self.env_name = "deepmimic_" + self.robot
        self.mocap_path = assets.mocap_path(self.robot, self.motion)
        self.xml_path = assets.xml_path(self.robot)


@dataclasses.dataclass
class DPEnvConfig:
    MAX_EP_LENGTH: int = 1000
    VEL_OBS_SCALE: float = 0.1
    FRC_OBS_SCALE: float = 0.001
    ADD_FOOT_CONTACT_OBS: bool = True
    ADD_EXTRA_CONTACT_OBS: bool = False
    ADD_TORSO_OBS: bool = True
    ADD_JOINT_FORCE_OBS: bool = False
    ADD_ABSPOS_OBS: bool = False
    ADD_PHASE_OBS: bool = True
    ADD_PLAYER_ACTION_OBS: bool = False
    MAX_PLAYER_ACTIONS: int = 3

    @property
    def __dict__copy(self):
        return dataclasses.asdict(self)
