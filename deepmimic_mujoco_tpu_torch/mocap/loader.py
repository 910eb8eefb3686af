"""Mocap clip loading and preprocessing (host-side, one-time).

Parses both clip formats the reference supports and reproduces its
conversion semantics (reference: src/mujoco/mocap_v2.py:33-336):

(a) DeepMimic format: ``{"Loop": ..., "Frames": [[dt, root_pos(3),
    root_quat(4 wxyz), joint quats/angles in DP order], ...]}`` —
    y-up→z-up alignment, per-ball-joint quat→intrinsic-xyz euler with a
    velocity-limited continuity singularity fix, then euler re-assembly
    into MuJoCo-layout qpos.
(b) ``"Format": "direct_qpos"``: frames are ``[dt] + qpos``.

Both formats then get: finite-difference qvel (root angular velocity
via quaternion log in the previous frame's local frame), per-frame FK
precompute of body/geom world positions (using this framework's own
forward kinematics instead of a throwaway env — the reference's
circular-dependency hack at src/mujoco/mocap_v2.py:292-307 is gone),
and integer-ratio linear interpolation of frames to the simulator dt.

All preprocessing is float64 numpy on host (the FK runs in float32 torch
on the CPU); the env uploads the result to its device once as float32.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from deepmimic_mujoco_tpu_torch.mocap import constants as C
from deepmimic_mujoco_tpu_torch.utils import hostquat as hq

SIM_DT = 0.01666  # simulator timestep the clips are resampled to
_DT_TOLERANCE = 0.1  # allowed deviation from an integer resample ratio


@dataclasses.dataclass
class MocapClip:
    """Preprocessed clip, ready for device upload."""
    motion_name: str
    dt: float
    loop: Optional[str]            # "wrap" | "none" | None
    qpos: np.ndarray               # (T, nq)
    qvel: np.ndarray               # (T, nv)
    body_xpos: np.ndarray          # (T, nbody, 3)
    geom_xpos: np.ndarray          # (T, ngeom, 3)

    def __len__(self):
        return len(self.qpos)

    # reference-compatible accessors (src/mujoco/mocap_v2.py:338-348)
    def get_length(self):
        return len(self.qpos)

    def get_qpos(self, idx):
        return self.qpos[idx]

    def get_qvel(self, idx):
        return self.qvel[idx]

    def get_body_xpos(self, idx):
        return self.body_xpos[idx]

    def get_geom_xpos(self, idx):
        return self.geom_xpos[idx]


# ---- y-up (DeepMimic) -> z-up (engine world) alignment ---------------
_L_MAT = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
_QL = hq.from_mat(_L_MAT)
_QR = hq.from_mat(_L_MAT.T)


def align_position(pos):
    return _L_MAT @ np.asarray(pos, dtype=np.float64)


def align_rotation(q_wxyz):
    return hq.mul(_QL, hq.mul(np.asarray(q_wxyz, dtype=np.float64), _QR))


def _fix_singularity(joint: str, e: np.ndarray, prev: np.ndarray,
                     q_target: np.ndarray, vmax: float, dt: float):
    """Continuity-mode euler selection for a ball joint.

    Clamp the raw intrinsic-xyz euler angles to a velocity- and
    limit-bounded box around the previous frame's choice; if the raw
    angles don't fit, grid-search the box for the euler triple whose
    quaternion best matches the target (sign-insensitive), preferring
    earlier candidates on ties (reference: src/mujoco/mocap_v2.py:196-225).
    """
    lims = (C.EX_LIM[joint], C.EY_LIM[joint], C.EZ_LIM[joint])
    lo = np.array([max(l[0], p - vmax * dt) for l, p in zip(lims, prev)])
    hi = np.array([min(l[1], p + vmax * dt) for l, p in zip(lims, prev)])
    tgt = np.clip(e, lo, hi)
    if np.allclose(e, tgt):
        return e
    # candidate grid per axis: [clamped, previous] + 6 linspace points
    cands = [np.concatenate(([tgt[i], prev[i]], np.linspace(lo[i], hi[i], 6)))
             for i in range(3)]
    ex, ey, ez = np.meshgrid(*cands, indexing="ij")  # ex slowest: loop order
    euler_grid = np.stack([ex.ravel(), ey.ravel(), ez.ravel()], axis=-1)
    qc = hq.euler_to_quat_intrinsic(euler_grid, "xyz")
    err = np.minimum(np.linalg.norm(qc - q_target, axis=-1),
                     np.linalg.norm(-qc - q_target, axis=-1)) ** 2
    best = int(np.argmin(err))  # first minimum == reference loop order
    return euler_grid[best]


def _parse_deepmimic_frames(frames: np.ndarray, dt: float,
                            fix_singularity: bool, vmax: float):
    """DeepMimic frames -> (T, 35) humanoid3d qpos array."""
    T = len(frames)
    # slice table in DP order
    widths = {3: 4, 1: 1}
    dp_slices = {}
    off = 8
    for j in C.BODY_JOINTS_IN_DP_ORDER:
        w = widths[C.DOF_DEF[j]]
        dp_slices[j] = (off, off + w)
        off += w

    prev_euler = {}
    qpos = np.zeros((T, 35))
    for k in range(T):
        f = frames[k]
        qpos[k, 0:3] = align_position(f[1:4])
        qpos[k, 3:7] = align_rotation(f[4:8])
        col = 7
        for j in C.BODY_JOINTS:
            s, e = dp_slices[j]
            if C.DOF_DEF[j] == 1:
                qpos[k, col] = f[s]
                col += 1
                continue
            q = align_rotation(f[s:e])
            eul = hq.quat_to_euler_intrinsic(q, "xyz")
            if fix_singularity and j in C.BALL_JOINTS:
                prev = prev_euler.get(j, eul)
                eul = _fix_singularity(j, eul, prev, q, vmax, dt)
                prev_euler[j] = eul
            qpos[k, col:col + 3] = eul
            col += 3
    return qpos


def _finite_diff_qvel(qpos: np.ndarray, dt: float) -> np.ndarray:
    """qvel[k] from (qpos[k-1], qpos[k]); qvel[0] = 0 (reference:
    src/mujoco/mocap_v2.py:274-289)."""
    T, nq = qpos.shape
    nv = nq - 1
    qvel = np.zeros((T, nv))
    prev = qpos[np.maximum(np.arange(T) - 1, 0)]
    qvel[:, 0:3] = (qpos[:, 0:3] - prev[:, 0:3]) / dt
    qvel[:, 3:6] = hq.vel_from_quats(prev[:, 3:7], qpos[:, 3:7], dt)
    qvel[:, 6:] = (qpos[:, 7:] - prev[:, 7:]) / dt
    return qvel


def _fk_precompute(model, qpos: np.ndarray):
    """Per-frame FK using the port's batched kinematics, on the CPU in
    float32 (the precision the JAX package computes it in)."""
    import torch

    from deepmimic_mujoco_tpu_torch.physics.kinematics import fwd_kinematics

    with torch.no_grad():
        kin = fwd_kinematics(model, torch.as_tensor(qpos, dtype=torch.float32))
    return (kin.xpos.double().numpy(), kin.geom_xpos.double().numpy())


def _interpolate(arrs, ratio: int):
    """Integer-ratio linear resampling, reference semantics: emits
    (T-1)*ratio frames, plain lerp incl. quaternions
    (src/mujoco/mocap_v2.py:317-336)."""
    out = []
    for a in arrs:
        T = len(a)
        ia = np.repeat(np.arange(T - 1), ratio)
        b_frac = np.tile(np.arange(ratio) / ratio, T - 1)
        shape = (len(ia),) + (1,) * (a.ndim - 1)
        B = b_frac.reshape(shape)
        out.append((1.0 - B) * a[ia] + B * a[ia + 1])
    return out


def load_clip(filepath: str, model, fix_singularity: bool = True) -> MocapClip:
    """Load + preprocess one clip against a PhysicsModel."""
    with open(filepath) as f:
        data = json.load(f)
    frames = np.asarray(data["Frames"], dtype=np.float64)
    loop = data.get("Loop")
    dt = float(frames[0][0])
    motion_name = os.path.splitext(os.path.basename(filepath))[0]

    if data.get("Format") == "direct_qpos":
        qpos = frames[:, 1:]
    else:
        vmax = 5.0 if "getup" in filepath else 10.0
        qpos = _parse_deepmimic_frames(frames, dt, fix_singularity, vmax)

    if qpos.shape[1] != model.nq:
        raise ValueError(
            f"clip {motion_name} has nq={qpos.shape[1]}, model expects {model.nq}")

    qvel = _finite_diff_qvel(qpos, dt)
    body_xpos, geom_xpos = _fk_precompute(model, qpos)

    ratio = dt / SIM_DT
    int_ratio = int(ratio)
    if abs(ratio - int_ratio) > _DT_TOLERANCE:
        raise ValueError(f"clip dt {dt} is not an integer multiple of "
                         f"sim dt {SIM_DT} (ratio {ratio})")
    if int_ratio > 1:
        qpos, qvel, body_xpos, geom_xpos = _interpolate(
            [qpos, qvel, body_xpos, geom_xpos], int_ratio)
        dt = SIM_DT

    return MocapClip(motion_name=motion_name, dt=dt, loop=loop,
                     qpos=qpos, qvel=qvel,
                     body_xpos=body_xpos, geom_xpos=geom_xpos)
