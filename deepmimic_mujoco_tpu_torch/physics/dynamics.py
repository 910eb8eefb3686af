"""Smooth dynamics: CRBA mass matrix, RNE bias forces, actuation.

Batch-major: every dynamic input carries a leading env axis ``B``. Tree
accumulations are dense mask matmuls against host-built static tables.
"""
from __future__ import annotations

import numpy as np
import torch

from deepmimic_mujoco_tpu_torch.models.physics_model import HINGE, PhysicsModel
from deepmimic_mujoco_tpu_torch.physics import spatial
from deepmimic_mujoco_tpu_torch.physics.kinematics import Com, tree_tables
from deepmimic_mujoco_tpu_torch.utils.device import const


def dof_ancestor_mask(m: PhysicsModel) -> np.ndarray:
    """Static (nv, nv) bool: mask[i, j] = dof i is on the root path of
    dof j (ancestor-or-self)."""
    nv = m.nv
    mask = np.zeros((nv, nv), dtype=bool)
    for j in range(nv):
        k = j
        while k >= 0:
            mask[k, j] = True
            k = int(m.dof_parentid[k])
    return mask


def body_dof_mask(m: PhysicsModel) -> np.ndarray:
    """Static (nbody, nv) bool: dofs that move each body."""
    mask = np.zeros((m.nbody, m.nv), dtype=bool)
    for b in range(1, m.nbody):
        i = b
        while i > 0:
            if m.body_dofnum[i] > 0:
                a = int(m.body_dofadr[i])
                mask[b, a:a + int(m.body_dofnum[i])] = True
            i = int(m.body_parentid[i])
    return mask


def crb(m: PhysicsModel, com: Com) -> torch.Tensor:
    """Composite-rigid-body mass matrix (B, nv, nv) + armature.

    Subtree inertia accumulation is one descendant-mask matmul; the
    matrix assembly is one (nv, 6) x (6, nv) matmul masked by the static
    ancestor pattern (upper triangle mirrored).
    """
    cdof = com.cdof
    B = cdof.shape[0]
    t = tree_tables(m)
    D = const(m, "descendants", lambda: t.descendants, cdof.device,
              cdof.dtype)
    Ic_tot = (D @ com.cinert.reshape(B, m.nbody, 36)).reshape(
        B, m.nbody, 6, 6)
    Icd = Ic_tot[:, np.asarray(m.dof_bodyid)]
    F = torch.einsum("bjac,bjc->bja", Icd, cdof)
    G = cdof @ F.transpose(-1, -2)   # G[i, j] = cdof_i . F_j
    mask = const(m, "dof_ancestor_mask", lambda: dof_ancestor_mask(m),
                 cdof.device)
    M = torch.triu(torch.where(mask, G, 0.0))
    M = M + M.transpose(-1, -2) - torch.diag_embed(
        torch.diagonal(M, dim1=-2, dim2=-1))
    arm = const(m, "dof_armature", lambda: m.dof_armature, cdof.device,
                cdof.dtype)
    return M + torch.diag(arm)


def rne(m: PhysicsModel, com: Com, cvel: torch.Tensor,
        cdof_dot: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
    """Bias force C(q, v) + gravity loads (qacc = 0), (B, nv).

    Forward acceleration propagation and backward force accumulation
    are dense mask matmuls (path-sum and subtree-sum respectively).
    """
    t = tree_tables(m)
    dev, dt = qvel.device, qvel.dtype
    a0 = const(m, "rne_a0", lambda: np.concatenate(
        [np.zeros(3), -np.asarray(m.opt.gravity)]), dev, dt)
    path = const(m, "body_dof_path", lambda: t.body_dof_path, dev, dt)
    cacc = a0 + path @ (cdof_dot * qvel[..., None])
    # world row gets a0 too but contributes nothing below
    Iv = torch.einsum("bnac,bnc->bna", com.cinert, cvel)
    f = (torch.einsum("bnac,bnc->bna", com.cinert, cacc)
         + spatial.force_cross(cvel, Iv))
    D = const(m, "descendants", lambda: t.descendants, dev, dt)
    ftot = D @ f                                           # subtree sums
    return (com.cdof * ftot[:, np.asarray(m.dof_bodyid)]).sum(-1)


def passive_force(m: PhysicsModel, qpos: torch.Tensor,
                  qvel: torch.Tensor) -> torch.Tensor:
    """Spring forces only (B, nv). Viscous damping and joint
    frictionloss are handled by the integrator (Euler: implicitly) —
    see Engine.forward."""
    frc = torch.zeros_like(qvel)
    if np.any(m.jnt_stiffness != 0):
        # hinge springs only (free-joint springs unused by these robots)
        for j in range(m.njnt):
            if m.jnt_type[j] == HINGE and m.jnt_stiffness[j] != 0:
                qadr, dadr = int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])
                frc[:, dadr] -= m.jnt_stiffness[j] * (
                    qpos[:, qadr] - m.jnt_springref[j])
    return frc


def actuator_force(m: PhysicsModel, ctrl: torch.Tensor) -> torch.Tensor:
    """Motor transmission: qfrc[dof(joint)] += gear * clip(ctrl)."""
    dev, dt = ctrl.device, ctrl.dtype
    lo = const(m, "ctrl_lo", lambda: m.actuator_ctrlrange[:, 0], dev, dt)
    hi = const(m, "ctrl_hi", lambda: m.actuator_ctrlrange[:, 1], dev, dt)
    limited = const(m, "ctrl_limited", lambda: m.actuator_ctrllimited, dev)
    gear = const(m, "gear", lambda: m.actuator_gear, dev, dt)
    c = torch.where(limited, torch.minimum(torch.maximum(ctrl, lo), hi), ctrl)
    dof_idx = const(m, "act_dof", lambda: np.asarray(
        [int(m.jnt_dofadr[j]) for j in m.actuator_trnid]), dev)
    qfrc = ctrl.new_zeros(ctrl.shape[0], m.nv)
    return qfrc.index_add_(1, dof_idx, c * gear)


def limited_hinge_table(m: PhysicsModel):
    """Static (dof_adr, qpos_adr, lo, hi) arrays for limited hinges;
    consumed by the constraint solver's joint-limit rows."""
    rows = [(int(m.jnt_dofadr[j]), int(m.jnt_qposadr[j]),
             float(m.jnt_range[j, 0]), float(m.jnt_range[j, 1]))
            for j in range(m.njnt)
            if m.jnt_type[j] == HINGE and m.jnt_limited[j]]
    if not rows:
        return (np.zeros(0, np.int64),) * 2 + (np.zeros(0),) * 2
    d, q, lo, hi = map(np.asarray, zip(*rows))
    return d, q, lo.astype(float), hi.astype(float)
