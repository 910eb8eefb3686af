"""Forward kinematics and com-frame quantities, batch-major.

Every function takes tensors with a leading env axis ``B`` and returns
the same fields as the JAX package's single-env functions with that axis
in front. Tree recursions walk *levels* of the link tree (depth ~7-11),
each level one batched step (see physics/tree.py); every accumulation
(subtree com, velocity propagation) is a dense 0/1-mask matmul.

Field semantics mirror the engine data the reference reads:
xpos/xquat, xipos, geom_xpos, cvel ([rot; lin], anchored at the subtree
com of the body's kinematic root).
"""
from typing import NamedTuple

import numpy as np
import torch

from deepmimic_mujoco_tpu_torch.models.physics_model import FREE, PhysicsModel
from deepmimic_mujoco_tpu_torch.physics import spatial
from deepmimic_mujoco_tpu_torch.physics.tree import (
    LINK_FREE, LINK_HINGE, TreeTables, build_tree_tables,
)
from deepmimic_mujoco_tpu_torch.utils import quat as tq
from deepmimic_mujoco_tpu_torch.utils.device import const

def tree_tables(m: PhysicsModel) -> TreeTables:
    """The model's tree tables, built once and kept on the model."""
    cache = m.__dict__.setdefault("_torch_consts", {})
    if "tree_tables" not in cache:
        cache["tree_tables"] = build_tree_tables(m)
    return cache["tree_tables"]


class Kin(NamedTuple):
    """Position-stage kinematics, batch-major."""
    xpos: torch.Tensor        # (B, nbody, 3)
    xquat: torch.Tensor       # (B, nbody, 4)
    xipos: torch.Tensor       # (B, nbody, 3)
    ximat: torch.Tensor       # (B, nbody, 3, 3)
    xanchor: torch.Tensor     # (B, njnt, 3)
    xaxis: torch.Tensor       # (B, njnt, 3)
    geom_xpos: torch.Tensor   # (B, ngeom, 3)
    geom_xmat: torch.Tensor   # (B, ngeom, 3, 3)
    site_xpos: torch.Tensor   # (B, nsite, 3)
    site_xmat: torch.Tensor   # (B, nsite, 3, 3)


class Com(NamedTuple):
    subtree_com: torch.Tensor  # (B, nbody, 3)
    cinert: torch.Tensor       # (B, nbody, 6, 6)
    cdof: torch.Tensor         # (B, nv, 6)


def _c(m, key, make, like):
    return const(m, key, make, like.device, like.dtype)


def _i(m, key, make, like):
    """Static index array as a tensor on ``like``'s device."""
    return const(m, key, lambda: np.asarray(make(), np.int64), like.device)


def fwd_kinematics(m: PhysicsModel, qpos: torch.Tensor) -> Kin:
    """qpos (B, nq) -> world frames, level-parallel."""
    B = qpos.shape[0]
    t = tree_tables(m)

    # slot-major buffers, world row prepended (index 0)
    world_quat = torch.zeros(B, 1, 4, dtype=qpos.dtype, device=qpos.device)
    world_quat[..., 0] = 1.0
    zeros3 = torch.zeros(B, 1, 3, dtype=qpos.dtype, device=qpos.device)
    pos_rows, quat_rows = [zeros3], [world_quat]
    anchor_rows, axis_rows = [zeros3], [zeros3]

    for gi, grp in enumerate(t.groups):
        pos_all = torch.cat(pos_rows, 1)
        quat_all = torch.cat(quat_rows, 1)
        pidx = _i(m, ("fk_pidx", gi), lambda: grp.parent_slot + 1, qpos)
        p_pos = pos_all[:, pidx]
        p_quat = quat_all[:, pidx]
        off_p = _c(m, ("fk_off_p", gi), lambda: grp.offset_pos, qpos)
        off_q = _c(m, ("fk_off_q", gi), lambda: grp.offset_quat, qpos)
        axis_l = _c(m, ("fk_axis", gi), lambda: grp.jnt_axis, qpos)
        pre_pos = p_pos + tq.rotate(p_quat, off_p.expand_as(p_pos))
        pre_quat = tq.mul(p_quat, off_q.expand_as(p_quat))

        if grp.link_type == LINK_FREE:
            qidx = _i(m, ("fk_qidx", gi),
                      lambda: grp.qpos_adr[:, None] + np.arange(7)[None], qpos)
            qv = qpos[:, qidx]  # (B, L, 7)
            new_pos = qv[..., :3]
            new_quat = tq.normalize(qv[..., 3:7])
            anchor = new_pos
            axis = axis_l.expand_as(new_pos)
        elif grp.link_type == LINK_HINGE:
            angle = qpos[:, _i(m, ("fk_qadr", gi), lambda: grp.qpos_adr,
                               qpos)]
            axis_b = axis_l.expand(B, -1, -1)
            jpos_l = _c(m, ("fk_jpos", gi), lambda: grp.jnt_pos,
                        qpos).expand(B, -1, -1)
            qj = tq.from_axis_angle(axis_b, angle)
            anchor = pre_pos + tq.rotate(pre_quat, jpos_l)
            new_quat = tq.mul(pre_quat, qj)
            new_pos = anchor - tq.rotate(new_quat, jpos_l)
            axis = tq.rotate(new_quat, axis_b)
        else:  # fixed
            new_pos, new_quat = pre_pos, pre_quat
            anchor = new_pos
            axis = axis_l.expand_as(new_pos)

        pos_rows.append(new_pos)
        quat_rows.append(new_quat)
        anchor_rows.append(anchor)
        axis_rows.append(axis)

    pos_all = torch.cat(pos_rows, 1)
    quat_all = torch.cat(quat_rows, 1)
    anchor_all = torch.cat(anchor_rows, 1)
    axis_all = torch.cat(axis_rows, 1)

    body_slot = _i(m, "fk_body_slot", lambda: t.body_slot + 1, qpos)
    jnt_slot = _i(m, "fk_jnt_slot", lambda: t.jnt_slot + 1, qpos)
    xpos = pos_all[:, body_slot]
    xquat = quat_all[:, body_slot]
    xanchor = anchor_all[:, jnt_slot]
    xaxis = axis_all[:, jnt_slot]

    def frame(body_np, pos_key, quat_key, local_pos, local_quat):
        bodyid = _i(m, pos_key + "_bodyid", lambda: body_np, qpos)
        lp = _c(m, pos_key, lambda: local_pos, qpos).expand(B, -1, -1)
        lq = _c(m, quat_key, lambda: local_quat, qpos).expand(B, -1, -1)
        return (xpos[:, bodyid] + tq.rotate(xquat[:, bodyid], lp),
                tq.to_mat(tq.mul(xquat[:, bodyid], lq)))

    allb = np.arange(m.nbody)
    xipos, ximat = frame(allb, "body_ipos", "body_iquat",
                         m.body_ipos, m.body_iquat)
    geom_xpos, geom_xmat = frame(np.asarray(m.geom_bodyid), "geom_pos",
                                 "geom_quat", m.geom_pos, m.geom_quat)
    if m.nsite:
        site_xpos, site_xmat = frame(np.asarray(m.site_bodyid), "site_pos",
                                     "site_quat", m.site_pos, m.site_quat)
    else:
        site_xpos = qpos.new_zeros(B, 0, 3)
        site_xmat = qpos.new_zeros(B, 0, 3, 3)

    return Kin(xpos=xpos, xquat=xquat, xipos=xipos, ximat=ximat,
               xanchor=xanchor, xaxis=xaxis,
               geom_xpos=geom_xpos, geom_xmat=geom_xmat,
               site_xpos=site_xpos, site_xmat=site_xmat)


def com_pos(m: PhysicsModel, kin: Kin) -> Com:
    """Subtree com, com-frame spatial inertias, motion subspace —
    accumulations as dense mask matmuls."""
    x = kin.xpos
    B = x.shape[0]
    t = tree_tables(m)
    mass = _c(m, "body_mass", lambda: m.body_mass, x)
    D = _c(m, "descendants", lambda: t.descendants, x)

    sub_mass = D @ mass
    sub_mom = D @ (mass[:, None] * kin.xipos)            # (B, nbody, 3)
    subtree_com = sub_mom / torch.clamp(sub_mass, min=1e-12)[:, None]

    anchor = subtree_com[:, np.asarray(m.body_rootid)]   # (B, nbody, 3)

    diag = torch.diag_embed(_c(m, "body_inertia", lambda: m.body_inertia, x))
    inertia_com = kin.ximat @ diag @ kin.ximat.transpose(-1, -2)
    cinert = spatial.inertia_matrix(mass.expand(B, -1), inertia_com,
                                    kin.xipos - anchor)

    # cdof: free root (6 rows) + hinges (1 row each), dof order
    rows = []
    hinge_jids = [j for j in range(m.njnt) if m.jnt_type[j] != FREE]
    free_jids = [j for j in range(m.njnt) if m.jnt_type[j] == FREE]
    assert free_jids in ([], [0]), "free joint must be the root joint"
    if free_jids:
        b = int(m.jnt_bodyid[0])
        o = anchor[:, b]
        eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(B, 3, 3)
        trans = torch.cat([torch.zeros_like(eye), eye], -1)  # (B, 3, 6)
        R = tq.to_mat(kin.xquat[:, b])
        u = R.transpose(-1, -2)  # row k = body axis k in world (R[:, k])
        lin = torch.linalg.cross(u, (o - x[:, b])[:, None, :].expand_as(u),
                                 dim=-1)
        rows.append(trans)
        rows.append(torch.cat([u, lin], -1))
    if hinge_jids:
        hj = np.asarray(hinge_jids)
        u = kin.xaxis[:, hj]
        a = kin.xanchor[:, hj]
        o = anchor[:, np.asarray(m.jnt_bodyid)[hj]]
        rows.append(torch.cat([u, torch.linalg.cross(u, o - a, dim=-1)], -1))
    cdof = torch.cat(rows, 1)
    return Com(subtree_com=subtree_com, cinert=cinert, cdof=cdof)


def com_vel(m: PhysicsModel, com: Com, qvel: torch.Tensor):
    """cvel (B, nbody, 6) per body + cdof time derivatives (B, nv, 6),
    via mask matmuls.

    cvel[i] = sum over root-path dofs of cdof*qvel; cdof_dot[j] is the
    motion cross of the velocity 'seen' by dof j (strict dof ancestors;
    a free joint's rotation subspace sees only its translations) with
    cdof[j].
    """
    t = tree_tables(m)
    wv = com.cdof * qvel[..., None]                          # (B, nv, 6)
    cvel = _c(m, "body_dof_path", lambda: t.body_dof_path, qvel) @ wv
    vseen = _c(m, "dof_seen", lambda: t.dof_seen, qvel) @ wv
    cdof_dot = spatial.motion_cross(vseen, com.cdof)
    keep = 1.0 - _c(m, "dof_free_trans", lambda: t.dof_free_trans, qvel)
    return cvel, cdof_dot * keep[:, None]


def mass_center(m: PhysicsModel, kin: Kin) -> torch.Tensor:
    """Mass-weighted com of all bodies, (B, 3)."""
    mass = _c(m, "body_mass", lambda: m.body_mass, kin.xipos)[:, None]
    return (mass * kin.xipos).sum(-2) / mass.sum()
