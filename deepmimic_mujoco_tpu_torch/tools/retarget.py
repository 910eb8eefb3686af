"""Humanoid3d -> Unitree G1 motion retargeting (host-side tool).

The port of the JAX package's ``tools/retarget.py`` (reference:
src/retarget.py:5-192): a per-joint name mapping with sign/offset and a
0.85 root scale, shoulder 3-DoF re-solved by converting the humanoid's
intrinsic-xyz euler to the G1's intrinsic-yxz convention with a
joint-limit + velocity-continuity grid search, writing a
``direct_qpos`` clip JSON. The retargeting is host numpy. It refuses to
overwrite an existing clip and ends with a perfect-tracking reward
validation on ``--device``.

The clip is written to ``models/assets.mocap_path("unitree_g1",
motion)``: under ``DM_TPU_ASSET_ROOT`` when that is set, else into the
vendored asset tree.

Usage: python -m deepmimic_mujoco_tpu_torch.tools.retarget --motion run
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from deepmimic_mujoco_tpu_torch.models import assets, load_model
from deepmimic_mujoco_tpu_torch.utils import hostquat as hq

# humanoid joint -> (g1 joint, offset, scale); None = dropped
# (reference: src/retarget.py:5-37)
NAIVE_MAP = {
    "root": ("floating_base_joint", 0.0,
             np.array([0.85, 0.85, 0.85, 1.0, 1.0, 1.0, 1.0])),
    "chest_x": None, "chest_y": None,
    "chest_z": ("torso_joint", 0.0, 1.0),
    "neck_x": None, "neck_y": None, "neck_z": None,
    "right_shoulder_x": ("right_shoulder_roll_joint", 0.0, 1.0),
    "right_shoulder_y": ("right_shoulder_pitch_joint", 0.0, 1.0),
    "right_shoulder_z": ("right_shoulder_yaw_joint", 0.0, 1.0),
    "right_elbow": ("right_elbow_pitch_joint", 1.57, -1.0),
    "left_shoulder_x": ("left_shoulder_roll_joint", 0.0, 1.0),
    "left_shoulder_y": ("left_shoulder_pitch_joint", 0.0, 1.0),
    "left_shoulder_z": ("left_shoulder_yaw_joint", 0.0, 1.0),
    "left_elbow": ("left_elbow_pitch_joint", 1.57, -1.0),
    "right_hip_x": ("right_hip_roll_joint", 0.0, 1.0),
    "right_hip_y": ("right_hip_pitch_joint", 0.0, 1.0),
    "right_hip_z": ("right_hip_yaw_joint", 0.0, 1.0),
    "right_knee": ("right_knee_joint", 0.0, -1.0),
    "right_ankle_x": ("right_ankle_roll_joint", 0.0, 1.0),
    "right_ankle_y": ("right_ankle_pitch_joint", 0.0, 1.0),
    "right_ankle_z": None,
    "left_hip_x": ("left_hip_roll_joint", 0.0, 1.0),
    "left_hip_y": ("left_hip_pitch_joint", 0.0, 1.0),
    "left_hip_z": ("left_hip_yaw_joint", 0.0, 1.0),
    "left_knee": ("left_knee_joint", 0.0, -1.0),
    "left_ankle_x": ("left_ankle_roll_joint", 0.0, 1.0),
    "left_ankle_y": ("left_ankle_pitch_joint", 0.0, 1.0),
    "left_ankle_z": None,
}

VMX = 15.0  # shoulder euler velocity limit (rad/s) for continuity


def _addr(model, name):
    a = model.get_joint_qpos_addr(name)
    return a if isinstance(a, tuple) else (a, a + 1)


def _continuity_pick(e_raw, prev, lims, q_target, vmax, dt):
    """Velocity/limit-bounded euler pick minimizing quat error
    (reference: src/retarget.py:83-136)."""
    lo = np.array([max(l[0], p - vmax * dt) for l, p in zip(lims, prev)])
    hi = np.array([min(l[1], p + vmax * dt) for l, p in zip(lims, prev)])
    tgt = np.clip(e_raw, lo, hi)
    if np.allclose(e_raw, tgt):
        return e_raw
    cands = [np.concatenate(([tgt[i], prev[i]], np.linspace(lo[i], hi[i], 6)))
             for i in range(3)]
    ex, ey, ez = np.meshgrid(*cands, indexing="ij")
    grid = np.stack([ex.ravel(), ey.ravel(), ez.ravel()], axis=-1)
    # candidates evaluated in the humanoid's rxyz convention (the
    # reference compares quaternion_from_euler(..., 'rxyz') to the target)
    qc = hq.euler_to_quat_intrinsic(grid, "xyz")
    err = np.minimum(np.linalg.norm(qc - q_target, axis=-1),
                     np.linalg.norm(-qc - q_target, axis=-1)) ** 2
    return grid[int(np.argmin(err))]


def retarget_motion_humanoid_to_unitree_g1(motion: str,
                                           overwrite: bool = False,
                                           validate: bool = True,
                                           device="cuda"):
    """Write the G1 clip of the humanoid's ``motion``; returns its path.
    ``validate`` then runs ``validate_clip`` on ``device``."""
    from deepmimic_mujoco_tpu_torch.mocap.loader import load_clip

    hum = load_model(assets.xml_path("humanoid3d"))
    g1 = load_model(assets.xml_path("unitree_g1"))
    clip = load_clip(assets.mocap_path("humanoid3d", motion), hum)
    dt = clip.dt

    prev_euler = {}
    frames = []
    for hqpos in clip.qpos:
        gq = np.zeros(g1.nq)
        for h_jname in hum.joint_names:
            mapping = NAIVE_MAP[h_jname]
            if mapping is None:
                continue
            g_jname, offset, scale = mapping
            off = offset
            if motion == "getup_facedown" and h_jname == "root":
                off = np.array([0, 0, 0.17, 0, 0, 0, 0.0])
            gs, ge = _addr(g1, g_jname)
            hs, he = _addr(hum, h_jname)
            gq[gs:ge] = hqpos[hs:he] * scale + off

        # shoulders: humanoid xy'z'' (intrinsic) -> G1 yx'z'' (intrinsic)
        for side in ("left", "right"):
            hr = gq[_addr(g1, f"{side}_shoulder_roll_joint")[0]]
            hp = gq[_addr(g1, f"{side}_shoulder_pitch_joint")[0]]
            hy = gq[_addr(g1, f"{side}_shoulder_yaw_joint")[0]]
            q_target = hq.euler_to_quat_intrinsic(
                np.array([hr, hp, hy]), "xyz")
            e_yxz = hq.quat_to_euler_intrinsic(q_target, "yxz")
            # yxz order: (pitch-about-y, roll-about-x, yaw-about-z)
            g1p, g1r, g1y = e_yxz
            lims = [g1.jnt_range[g1.joint_name2id(
                f"{side}_shoulder_{ax}_joint")] for ax in ("roll", "pitch",
                                                          "yaw")]
            prev = prev_euler.get(side, np.array([g1r, g1p, g1y]))
            e_pick = _continuity_pick(np.array([g1r, g1p, g1y]), prev,
                                      lims, q_target, VMX, dt)
            prev_euler[side] = e_pick
            g1r, g1p, g1y = e_pick
            if motion == "getup_facedown":
                chest_y = hqpos[_addr(hum, "chest_y")[0]]
                g1p = g1p - 0.4 + chest_y  # the reference's prone-pose hack
            gq[_addr(g1, f"{side}_shoulder_roll_joint")[0]] = g1r
            gq[_addr(g1, f"{side}_shoulder_pitch_joint")[0]] = g1p
            gq[_addr(g1, f"{side}_shoulder_yaw_joint")[0]] = g1y

        frames.append([dt] + gq.tolist())

    json_dict = {
        "Format": "direct_qpos",
        "JointNames": list(g1.joint_names),
        "Labels": (["dt"]
                   + [g1.joint_names[0] + sfx for sfx in
                      ["_x", "_y", "_z", "_qw", "_qx", "_qy", "_qz"]]
                   + list(g1.joint_names[1:])),
        "Loop": clip.loop,
        "Frames": frames,
    }
    out_path = assets.mocap_path("unitree_g1", motion)
    if os.path.exists(out_path) and not overwrite:
        raise FileExistsError(f"File exists: {out_path} "
                              "(refusing to overwrite)")
    with open(out_path, "w") as f:
        json.dump(json_dict, f, indent=4)
    print("Retargeted motion saved to", out_path)

    if validate:
        validate_clip(motion, device=device)
    return out_path


def validate_clip(motion: str, robot: str = "unitree_g1", device="cuda"):
    """Perfect-tracking reward sweep over the clip (the reference's
    acceptance check, src/retarget.py:192): from frame 0, every step
    forces the state to the clip's current frame (``force_state``, so no
    dynamics run) and records the reward. Returns the rewards."""
    from deepmimic_mujoco_tpu_torch.envs import DPEnv

    env = DPEnv(motion=motion, robot=robot, device=device)
    zero = torch.zeros(1, env.action_size, device=env.device)
    rews = []
    with torch.no_grad():
        state, _ = env.reset(1, idx_init=0)
        for _ in range(env.mocap_data_len - 1):
            i = int(state.idx_curr[0])
            state, out = env.step(state, zero, force_state=(
                env.mocap_qpos[i:i + 1], env.mocap_qvel[i:i + 1]))
            rews.append(float(out.reward[0]))
    rews = np.asarray(rews)
    print(f"validate {motion}: perfect-tracking reward "
          f"mean {rews.mean():.3f} min {rews.min():.3f}")
    return rews


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--motion", default="run")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--validate-only", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.validate_only:
        validate_clip(args.motion, device=args.device)
    else:
        retarget_motion_humanoid_to_unitree_g1(
            args.motion, overwrite=args.overwrite, device=args.device)


if __name__ == "__main__":
    main()
