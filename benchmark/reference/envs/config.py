"""Env configuration objects (reference: src/config.py:3-49,
src/deepmimic_env.py:258-270, src/combined_env.py:21-35).

Path resolution goes through :mod:`reference.models.assets`
(env var ``DM_TPU_ASSET_ROOT``) instead of the reference's hardcoded
``~/Code/DeepMimic_mujoco/src``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from reference.models import assets


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


@dataclasses.dataclass
class DPCombinedEnvConfig:
    MAX_EP_LENGTH: int = 2000
    VEL_OBS_SCALE: float = 0.1
    FRC_OBS_SCALE: float = 0.001
    ADD_FOOT_CONTACT_OBS: bool = False
    ADD_EXTRA_CONTACT_OBS: bool = True
    ACT_SCALE: float = 20.0
    ADD_TORSO_OBS: bool = True
    ADD_JOINT_FORCE_OBS: bool = False
    ADD_ABSPOS_OBS: bool = False
    ADD_PHASE_OBS: bool = True
    ADD_PLAYER_ACTION_OBS: bool = True
    MAX_PLAYER_ACTIONS: int = 3
    AMNESTY_STEPS: int = 150
    # ---- training-only RSI shaping (defaults = reference behavior,
    # src/combined_env.py:208-244) ------------------------------------
    # fraction of resets placed in the LAST quarter of the getup clip,
    # so the policy practices the getup -> locomotion handoff
    HANDOFF_RSI_FRAC: float = 0.0
    # randomize the reset player action between walk and run (reference
    # resets always command walk)
    RSI_RANDOM_PA: bool = False
    # fraction of resets drawn from the ON-POLICY handoff buffer: the
    # trainer captures the physical (qpos, qvel) at every GETUP ->
    # locomotion transition the current policy reaches, so the handoff
    # is practiced from the state distribution the policy really meets
    HANDOFF_BUFFER_FRAC: float = 0.0
    # fraction of resets at the getup clip's FIRST frame with ZERO
    # velocity: the state an injected or real fall produces
    FACEDOWN_RSI_FRAC: float = 0.0
