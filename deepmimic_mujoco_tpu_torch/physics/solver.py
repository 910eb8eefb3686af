"""Constraint solver: soft contacts + joint limits in dual (force) space.

Constraint accelerations are driven toward ``aref = -b*vel - k*imp*pos``
through the impedance-regularized system

    A = J M^-1 J^T + diag(R),   R_i = (1 - imp_i)/imp_i * A_ii,

solved by the fused mass-matrix + constraint solve
(``ops/fused_solve.py``: the CUDA kernel on the card, its plain torch
version on the CPU). Contacts use an elliptic friction cone by default;
joint limits are unilateral rows with J = +-e_dof.

Fixed shapes: K contact slots * 3 rows (normals | t1 | t2) + L limit
rows, activity handled by masks. The per-env J is never formed here:
the solve entry builds J^T from the contact-Jacobian parts.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from deepmimic_mujoco_tpu_torch.models.physics_model import PhysicsModel
from deepmimic_mujoco_tpu_torch.ops.fused_solve import fused_solve_parts
from deepmimic_mujoco_tpu_torch.physics.collision import Contacts
from deepmimic_mujoco_tpu_torch.physics.kinematics import Com
from deepmimic_mujoco_tpu_torch.utils import tracing
from deepmimic_mujoco_tpu_torch.utils.device import const

_LIMIT_SOLREF = (0.02, 1.0)
_LIMIT_SOLIMP = (0.9, 0.95, 0.001, 0.5, 2.0)


class SolveResult(NamedTuple):
    qacc: torch.Tensor             # (B, nv)
    qfrc_constraint: torch.Tensor  # (B, nv)
    lam: torch.Tensor              # (B, K*3 + L) constraint forces


def _impedance(solimp, pos):
    """solimp = (dmin, dmax, width, midpoint, power); pos<0 = violated."""
    dmin, dmax, width, mid, power = solimp.unbind(-1)
    x = torch.clamp(torch.abs(pos) / torch.clamp(width, min=1e-10), 0.0, 1.0)
    a = 1.0 / torch.clamp(mid, min=1e-6) ** (power - 1)
    b = 1.0 / torch.clamp(1 - mid, min=1e-6) ** (power - 1)
    y = torch.where(x < mid, a * x ** power, 1.0 - b * (1.0 - x) ** power)
    return torch.clamp(dmin + y * (dmax - dmin), 1e-5, 1.0 - 1e-5)


def _kb(solref, solimp, dt: float = 0.0):
    """(stiffness k, damping b) from solref=(timeconst, dampratio).

    Like the reference engine, the time constant is clamped to at least
    2*timestep — without the clamp dt*b ~= 1.75 makes every loaded
    contact a marginal discrete oscillator that pumps energy into the
    tree.
    """
    timeconst = torch.clamp(solref[..., 0], min=2.0 * dt)
    dampratio = solref[..., 1]
    dmax = solimp[..., 1]
    b = 2.0 / torch.clamp(dmax * timeconst, min=1e-10)
    k = 1.0 / torch.clamp(
        dmax * dmax * timeconst * timeconst * dampratio * dampratio,
        min=1e-10)
    return k, b


def contact_jac_parts(m: PhysicsModel, com: Com, contacts: Contacts,
                      body_dof: np.ndarray):
    """Raw pieces of the contact Jacobian: cd_lin (B, nv, 3), cd_ang
    (B, nv, 3), rpos (B, K, 3) contact point rel. the root subtree com,
    w (B, K, nv) signed body-path dof mask."""
    dev, dt = contacts.pos.device, contacts.pos.dtype
    g2b = const(m, "geom_bodyid", lambda: np.asarray(m.geom_bodyid), dev)
    b1 = g2b[contacts.geom1]
    b2 = g2b[contacts.geom2]
    anchor = com.subtree_com[:, int(m.body_rootid[-1])]
    cd_ang = com.cdof[..., :3]
    cd_lin = com.cdof[..., 3:]
    rpos = contacts.pos - anchor[:, None, :]
    mask = const(m, "body_dof", lambda: body_dof, dev, dt)  # (nbody, nv)
    w = mask[b2] - mask[b1]
    return cd_lin, cd_ang, rpos, w


def solve_constraints(m: PhysicsModel, com: Com, M_hat: torch.Tensor,
                      qfrc_smooth: torch.Tensor, qpos: torch.Tensor,
                      qvel: torch.Tensor, contacts: Contacts,
                      body_dof: np.ndarray, limit_table,
                      iterations: int = 50,
                      lam0=None, cone: str = "elliptic") -> SolveResult:
    """``M_hat`` (B, nv, nv) is the implicit-damping-augmented mass
    matrix; the inverse-mass solve happens inside the fused solve."""
    dt = m.opt.timestep
    dev, dtype = qfrc_smooth.device, qfrc_smooth.dtype
    K = contacts.dist.shape[1]
    if not iterations:
        # constraints disabled (smooth-parity tests): the JAX package
        # returns qacc_smooth with zero constraint force and zero lam
        Lc, _ = torch.linalg.cholesky_ex(M_hat)
        qacc = torch.cholesky_solve(qfrc_smooth[..., None], Lc)[..., 0]
        return SolveResult(
            qacc=qacc, qfrc_constraint=torch.zeros_like(qfrc_smooth),
            lam=qfrc_smooth.new_zeros(qfrc_smooth.shape[0],
                                      3 * K + len(limit_table[0])))

    # ---- contact rows (segment-major: normals | t1 | t2 | limits) -----
    # the contact velocity contracts through u = sum_n w v cd (Jp v =
    # u_lin + u_ang x r per contact)
    cd_lin, cd_ang, rpos, w = contact_jac_parts(m, com, contacts, body_dof)
    wv = w * qvel[:, None, :]
    u_lin = wv @ cd_lin                          # (B, K, 3)
    u_ang = wv @ cd_ang
    vel_c = torch.einsum("bkrd,bkd->bkr", contacts.frame,
                         u_lin + torch.linalg.cross(u_ang, rpos, dim=-1))
    pos_c = contacts.dist - contacts.includemargin
    active_c = pos_c < 0.0
    imp_c = _impedance(contacts.solimp, pos_c)
    k_c, b_c = _kb(contacts.solref, contacts.solimp, dt)
    aref_c = -b_c[..., None] * vel_c
    aref_c[..., 0] -= k_c * imp_c * pos_c

    aref = [aref_c[..., 0], aref_c[..., 1], aref_c[..., 2]]
    imp = [imp_c] * 3
    active = [active_c] * 3

    # ---- joint-limit rows (J_l = +-e_dof: never materialized) ----------
    ld, lq, llo, lhi = limit_table
    L = len(ld)
    sign = qpos.new_zeros(qpos.shape[0], 0)
    if L:
        qj = qpos[:, np.asarray(lq)]
        vj = qvel[:, np.asarray(ld)]
        dist_lo = qj - const(m, "limit_lo", lambda: llo, dev, dtype)
        dist_hi = const(m, "limit_hi", lambda: lhi, dev, dtype) - qj
        # one row per joint: the nearer limit (both can't bind at once)
        use_lo = dist_lo < dist_hi
        pos_l = torch.where(use_lo, dist_lo, dist_hi)
        sign = torch.where(use_lo, 1.0, -1.0).to(dtype)
        solimp_l = const(m, "limit_solimp", lambda: np.asarray(_LIMIT_SOLIMP),
                         dev, dtype)
        solref_l = const(m, "limit_solref", lambda: np.asarray(_LIMIT_SOLREF),
                         dev, dtype)
        imp_l = _impedance(solimp_l, pos_l)
        k_l, b_l = _kb(solref_l, solimp_l, dt)
        aref.append(-b_l * (sign * vj) - k_l * imp_l * pos_l)
        imp.append(imp_l)
        active.append(pos_l < 0.0)

    if lam0 is None:
        lam0 = qpos.new_zeros(qpos.shape[0], 3 * K + L)
    aref, imp = torch.cat(aref, 1), torch.cat(imp, 1)
    active = torch.cat(active, 1).to(dtype)
    if tracing.on():
        # slot occupancy, summed only when read (no kernel, no sync here)
        B = active.shape[0]
        tracing.count("solve.slots", B * K)
        tracing.count("solve.active_slots", active[:, :K])
        tracing.count("solve.limit_rows", B * L)
        tracing.count("solve.active_limit_rows", active[:, 3 * K:])
    with tracing.span("engine.solve"):
        qacc, qfrc, lam = fused_solve_parts(
            M_hat, cd_lin, cd_ang, contacts.frame, rpos, w, sign,
            qfrc_smooth, aref, imp, active,
            contacts.friction[..., 0], lam0, K=K, L=L,
            ld_idx=tuple(int(i) for i in ld), iterations=iterations,
            pyramidal=(cone == "pyramidal"))
    return SolveResult(qacc=qacc, qfrc_constraint=qfrc, lam=lam)
