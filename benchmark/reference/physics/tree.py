"""Static tree tables for level-wise, matmul-based dynamics.

Per-body sequential chains cost one small launch per body. These
host-built tables turn tree recursions into
  (a) level-parallel batches for forward kinematics (depth ~10 levels
      instead of ~40 per-body chains), and
  (b) dense 0/1 ancestor/descendant matrices so every accumulation pass
      (subtree com, composite inertia, velocity/acceleration propagation,
      force back-substitution) is ONE batched matmul.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from reference.models.physics_model import FREE, PhysicsModel

LINK_FIXED, LINK_HINGE, LINK_FREE = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class LevelGroup:
    """Links of one (level, type) batch."""
    link_type: int
    parent_slot: np.ndarray   # index into level-major output (-1 world)
    offset_pos: np.ndarray    # (L, 3) fixed transform before the joint
    offset_quat: np.ndarray   # (L, 4)
    jnt_axis: np.ndarray      # (L, 3)
    jnt_pos: np.ndarray       # (L, 3)
    qpos_adr: np.ndarray      # (L,)
    jnt_id: np.ndarray        # (L,) joint id (-1 fixed)


@dataclasses.dataclass(frozen=True)
class TreeTables:
    groups: Tuple[LevelGroup, ...]
    nlink: int
    body_slot: np.ndarray       # (nbody,) body frame's slot (-1 world)
    jnt_slot: np.ndarray        # (njnt,) slot of each joint's link
    # dense masks
    descendants: np.ndarray     # (nbody, nbody) D[i,j]=1 if j in subtree(i)
    body_dof_path: np.ndarray   # (nbody, nv) dofs on root path of body
    dof_seen: np.ndarray        # (nv, nv) S[j,k]: dof k's velocity is
    #                             "seen" by dof j's cdof_dot
    cdof_perm: np.ndarray       # (nv,) slot/dof bookkeeping: joint of dof
    dof_jnt: np.ndarray         # (nv,) joint id per dof
    dof_free_trans: np.ndarray  # (nv,) 1 where dof is a free translation


def build_tree_tables(m: PhysicsModel) -> TreeTables:
    # ---- links: one per joint; plus one fixed link per jointless body
    links = []  # dict per link
    body_last_link = np.full(m.nbody, -1, dtype=np.int64)
    for b in range(1, m.nbody):
        parent_body = int(m.body_parentid[b])
        parent_link = int(body_last_link[parent_body]) if parent_body > 0 else -1
        njnt = int(m.body_jntnum[b])
        if njnt == 0:
            links.append(dict(type=LINK_FIXED, parent=parent_link,
                              off_pos=m.body_pos[b], off_quat=m.body_quat[b],
                              axis=np.zeros(3), jpos=np.zeros(3),
                              qadr=0, jid=-1))
            body_last_link[b] = len(links) - 1
            continue
        j0 = int(m.body_jntadr[b])
        for k in range(njnt):
            j = j0 + k
            first = k == 0
            links.append(dict(
                type=LINK_FREE if m.jnt_type[j] == FREE else LINK_HINGE,
                parent=parent_link,
                off_pos=m.body_pos[b] if first else np.zeros(3),
                off_quat=m.body_quat[b] if first else np.array([1.0, 0, 0, 0]),
                axis=m.jnt_axis[j], jpos=m.jnt_pos[j],
                qadr=int(m.jnt_qposadr[j]), jid=j))
            parent_link = len(links) - 1
        body_last_link[b] = parent_link

    nlink = len(links)
    depth = np.zeros(nlink, dtype=np.int64)
    for i, L in enumerate(links):
        depth[i] = 0 if L["parent"] < 0 else depth[L["parent"]] + 1

    # level-major slot order: stable sort by (depth, type) groups
    order: List[int] = []
    groups: List[LevelGroup] = []
    slot_of_link = np.full(nlink, -1, dtype=np.int64)
    for d in range(int(depth.max()) + 1):
        for t in (LINK_FREE, LINK_HINGE, LINK_FIXED):
            ids = [i for i in range(nlink)
                   if depth[i] == d and links[i]["type"] == t]
            if not ids:
                continue
            for i in ids:
                slot_of_link[i] = len(order)
                order.append(i)
            groups.append(LevelGroup(
                link_type=t,
                parent_slot=np.array([
                    slot_of_link[links[i]["parent"]]
                    if links[i]["parent"] >= 0 else -1 for i in ids]),
                offset_pos=np.stack([links[i]["off_pos"] for i in ids]),
                offset_quat=np.stack([links[i]["off_quat"] for i in ids]),
                jnt_axis=np.stack([links[i]["axis"] for i in ids]),
                jnt_pos=np.stack([links[i]["jpos"] for i in ids]),
                qpos_adr=np.array([links[i]["qadr"] for i in ids]),
                jnt_id=np.array([links[i]["jid"] for i in ids]),
            ))

    body_slot = np.array([slot_of_link[body_last_link[b]]
                          if body_last_link[b] >= 0 else -1
                          for b in range(m.nbody)])
    jnt_slot = np.full(m.njnt, -1, dtype=np.int64)
    for i, L in enumerate(links):
        if L["jid"] >= 0:
            jnt_slot[L["jid"]] = slot_of_link[i]

    # ---- dense masks ----------------------------------------------------
    nb, nv = m.nbody, m.nv
    descendants = np.zeros((nb, nb))
    for j in range(1, nb):
        i = j
        while i > 0:
            descendants[i, j] = 1.0
            i = int(m.body_parentid[i])

    body_dof_path = np.zeros((nb, nv))
    for b in range(1, nb):
        i = b
        while i > 0:
            if m.body_dofnum[i] > 0:
                a = int(m.body_dofadr[i])
                body_dof_path[b, a:a + int(m.body_dofnum[i])] = 1.0
            i = int(m.body_parentid[i])

    # dof_seen: strict dof-tree ancestors, minus rotation-rotation pairs
    # within the same free joint (matches the engine's cdof_dot rule).
    dof_seen = np.zeros((nv, nv))
    for j in range(nv):
        k = int(m.dof_parentid[j])
        while k >= 0:
            dof_seen[j, k] = 1.0
            k = int(m.dof_parentid[k])
    dof_free_trans = np.zeros(nv)
    for j in range(m.njnt):
        if m.jnt_type[j] == FREE:
            a = int(m.jnt_dofadr[j])
            dof_free_trans[a:a + 3] = 1.0
            for r1 in range(a + 3, a + 6):
                for r2 in range(a + 3, a + 6):
                    dof_seen[r1, r2] = 0.0

    dof_jnt = np.asarray(m.dof_jntid)
    return TreeTables(
        groups=tuple(groups), nlink=nlink, body_slot=body_slot,
        jnt_slot=jnt_slot, descendants=descendants,
        body_dof_path=body_dof_path, dof_seen=dof_seen,
        cdof_perm=np.arange(nv), dof_jnt=dof_jnt,
        dof_free_trans=dof_free_trans)
