"""Collision detection: static pair tables -> fixed-size contact set.

The candidate pair list is enumerated at model-build time (with <100
bodies a static table is cheaper than a per-step broadphase and keeps
every shape constant). The narrow phase runs batch-major per pair-kind
group; each group emits (B, nslot * npair) contact slots, concatenated
in a fixed group-major, sample-major order. The solver consumes the
top-K deepest slots (all active contacts are kept whenever
#active <= K).

Kinds: plane-{sphere, capsule, box, mesh}, sphere-sphere,
sphere-capsule, capsule-capsule, sphere-box (point-box), capsule-box
(segment-box sampling) and box-box (corner sampling, 4 deepest). Mesh
geoms collide with the floor through their hull vertices (the 4 lowest)
and with everything else through capsule proxies resolved on the host.

Vectors are tensors with a trailing axis of 3. Dot products, crosses
and rotations are written out component by component in the same order
as the JAX package's struct-of-arrays code, so both round alike.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from deepmimic_mujoco_tpu_torch.models.physics_model import (
    BOX, CAPSULE, CYLINDER, MESH, PLANE, SPHERE, PhysicsModel,
)
from deepmimic_mujoco_tpu_torch.physics.kinematics import Kin
from deepmimic_mujoco_tpu_torch.utils.device import const

# narrow-phase group ids
K_PLANE_SPHERE, K_PLANE_CAPSULE, K_PLANE_BOX, K_PLANE_MESH = 0, 1, 2, 3
K_SPHERE_SPHERE, K_SPHERE_CAPSULE, K_CAPSULE_CAPSULE = 4, 5, 6
K_SPHERE_BOX, K_CAPSULE_BOX, K_BOX_BOX = 7, 8, 9

_SLOTS = {K_PLANE_SPHERE: 1, K_PLANE_CAPSULE: 2, K_PLANE_BOX: 4,
          K_PLANE_MESH: 4, K_SPHERE_SPHERE: 1, K_SPHERE_CAPSULE: 1,
          K_CAPSULE_CAPSULE: 1, K_SPHERE_BOX: 1, K_CAPSULE_BOX: 1,
          K_BOX_BOX: 4}


class Contacts(NamedTuple):
    """Fixed-size contact buffer, batch-major."""
    dist: torch.Tensor      # (B, ncon) signed distance (<0 = penetration)
    pos: torch.Tensor       # (B, ncon, 3) world contact point
    frame: torch.Tensor     # (B, ncon, 3, 3) rows: normal, tangent1, tangent2
    geom1: torch.Tensor     # (B, ncon) int64
    geom2: torch.Tensor     # (B, ncon) int64
    includemargin: torch.Tensor  # (B, ncon) margin for activation
    friction: torch.Tensor  # (B, ncon, 3)
    solref: torch.Tensor    # (B, ncon, 2)
    solimp: torch.Tensor    # (B, ncon, 5)
    condim: torch.Tensor    # (B, ncon) int64
    overflow: torch.Tensor  # (B,) int64: active contacts dropped by top-K
    slot_idx: torch.Tensor  # (B, ncon) int64 static pair-slot id of each
    #                         compacted slot; keys the engine's warm start


class PairGroup(NamedTuple):
    """Unique pairs of one narrow-phase kind (host-side, static)."""
    kind: int
    g1: np.ndarray         # (npair,)
    g2: np.ndarray
    # per-SLOT metadata, flattened (npair * nslot,)
    margin: np.ndarray
    friction: np.ndarray
    solref: np.ndarray
    solimp: np.ndarray
    condim: np.ndarray
    # distance offset per slot: mesh proxy capsules are fatter than the
    # true hulls, so pairs that falsely overlap at a reference pose get
    # their rest overlap subtracted (see calibrate_proxy_gaps)
    gap: np.ndarray
    is_proxy: np.ndarray   # (npair,) bool: either geom collides via proxy
    # sub-capsule index per pair side (-1 = whole-mesh PCA capsule /
    # primitive); >=0 selects Mesh.sub_capsules[i]
    sub1: np.ndarray = None
    sub2: np.ndarray = None


def _as_capsule_kind(t: int) -> int:
    return CAPSULE if t == CYLINDER else t


def _n_subs(m: PhysicsModel, g: int, mesh_subcapsules: int) -> int:
    mid = int(m.geom_meshid[g])
    if mesh_subcapsules <= 1 or mid < 0:
        return 0
    return len(m.meshes[mid].sub_capsules) or 0


def build_pair_tables(m: PhysicsModel,
                      mesh_subcapsules: int = 1) -> List[PairGroup]:
    """Classify candidate pairs into narrow-phase groups.

    ``mesh_subcapsules > 1`` expands each mesh-involved (non-plane)
    pair over the meshes' sub-capsule decompositions.
    """
    groups: Dict[int, dict] = {}
    for g1, g2 in zip(m.pair_geom1, m.pair_geom2):
        t1 = _as_capsule_kind(int(m.geom_type[g1]))
        t2 = _as_capsule_kind(int(m.geom_type[g2]))
        if t2 == PLANE or (t1 != PLANE and t1 > t2):
            g1, g2, t1, t2 = g2, g1, t2, t1
        key = (t1, t2)
        if t1 == PLANE:
            kind = {SPHERE: K_PLANE_SPHERE, CAPSULE: K_PLANE_CAPSULE,
                    BOX: K_PLANE_BOX, MESH: K_PLANE_MESH}.get(t2)
        else:
            kind = {(SPHERE, SPHERE): K_SPHERE_SPHERE,
                    (SPHERE, CAPSULE): K_SPHERE_CAPSULE,
                    (CAPSULE, CAPSULE): K_CAPSULE_CAPSULE,
                    (SPHERE, BOX): K_SPHERE_BOX,
                    (CAPSULE, BOX): K_CAPSULE_BOX,
                    (BOX, BOX): K_BOX_BOX,
                    # mesh pairs via capsule proxies
                    (SPHERE, MESH): K_SPHERE_CAPSULE,
                    (CAPSULE, MESH): K_CAPSULE_CAPSULE,
                    (BOX, MESH): K_CAPSULE_BOX,
                    (MESH, MESH): K_CAPSULE_CAPSULE,
                    }.get(key)
            if key == (BOX, MESH):
                g1, g2 = g2, g1  # capsule(proxy) first, box second
        if kind is None:
            continue
        grp = groups.setdefault(kind, {k: [] for k in (
            "g1", "g2", "sub1", "sub2", "margin", "friction", "solref",
            "solimp", "condim")})
        # sub-capsule expansion (proxies only; plane-mesh is exact)
        n1 = _n_subs(m, g1, mesh_subcapsules) if kind != K_PLANE_MESH else 0
        n2 = _n_subs(m, g2, mesh_subcapsules) if kind != K_PLANE_MESH else 0
        for s1 in (range(n1) if n1 else (-1,)):
            for s2 in (range(n2) if n2 else (-1,)):
                grp["g1"].append(int(g1))
                grp["g2"].append(int(g2))
                grp["sub1"].append(s1)
                grp["sub2"].append(s2)
                grp["margin"].append(
                    max(m.geom_margin[g1], m.geom_margin[g2]))
                grp["friction"].append(
                    np.maximum(m.geom_friction[g1], m.geom_friction[g2]))
                grp["solref"].append(
                    (m.geom_solref[g1] + m.geom_solref[g2]) / 2.0)
                grp["solimp"].append(
                    (m.geom_solimp[g1] + m.geom_solimp[g2]) / 2.0)
                grp["condim"].append(
                    max(m.geom_condim[g1], m.geom_condim[g2]))

    out = []
    for kind in sorted(groups):
        g = groups[kind]
        ns = _SLOTS[kind]
        # SAMPLE-MAJOR slot tiling: slot s of all pairs, then slot s+1
        rep = lambda a: np.tile(
            np.asarray(a), (ns,) + (1,) * (np.asarray(a).ndim - 1))
        g1a, g2a = np.asarray(g["g1"]), np.asarray(g["g2"])
        is_proxy = np.array(
            [kind != K_PLANE_MESH
             and (m.geom_meshid[a] >= 0 or m.geom_meshid[b] >= 0)
             for a, b in zip(g1a, g2a)], dtype=bool)
        out.append(PairGroup(
            kind=kind, g1=g1a, g2=g2a,
            margin=rep(g["margin"]), friction=rep(g["friction"]),
            solref=rep(g["solref"]), solimp=rep(g["solimp"]),
            condim=rep(g["condim"]).astype(np.int32),
            gap=np.zeros(len(g1a) * ns), is_proxy=is_proxy,
            sub1=np.asarray(g["sub1"], np.int64),
            sub2=np.asarray(g["sub2"], np.int64)))
    return out


def calibrate_proxy_gaps(m: PhysicsModel, tables: List[PairGroup],
                         calib_qpos: np.ndarray) -> List[PairGroup]:
    """Zero out false rest-pose overlaps of mesh proxy capsules.

    Runs the narrow phase once at a reference pose (keyframe if the
    model has one) on the CPU and, for proxy-involved slots that report
    penetration there, subtracts that rest overlap from all future
    distances.
    """
    from deepmimic_mujoco_tpu_torch.physics.kinematics import fwd_kinematics

    need = [grp for grp in tables if grp.is_proxy.any()]
    if not need:
        return list(tables)
    q = torch.as_tensor(np.asarray(calib_qpos), dtype=torch.float32)[None]
    with torch.no_grad():
        kin = fwd_kinematics(m, q)
        ds = [_narrow_groups(m, [grp], kin)[0][0][0] for grp in need]
    gaps = {id(grp): d.double().numpy() for grp, d in zip(need, ds)}
    out = []
    for grp in tables:
        if id(grp) not in gaps:
            out.append(grp)
            continue
        d = gaps[id(grp)]
        ns = _SLOTS[grp.kind]
        proxy_slot = np.tile(grp.is_proxy, ns)
        gap = np.where(proxy_slot, np.minimum(d - grp.margin, 0.0), 0.0)
        out.append(grp._replace(gap=gap))
    return out


def total_slots(tables: List[PairGroup]) -> int:
    return sum(len(t.g1) * _SLOTS[t.kind] for t in tables)


# ---------------- vector helpers (trailing axis of 3) -----------------

def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _rot(R, v):
    """R @ v as a sum of scaled columns (v constant or per pair)."""
    return (R[..., :, 0] * v[..., 0:1] + R[..., :, 1] * v[..., 1:2]
            + R[..., :, 2] * v[..., 2:3])


def _rot_t(R, w):
    """R^T @ w: dot products with the columns."""
    return torch.stack([_dot(R[..., :, 0], w), _dot(R[..., :, 1], w),
                        _dot(R[..., :, 2], w)], -1)


def _normalized(dvec, eps=1e-9):
    return dvec * (1.0 / torch.clamp(_norm(dvec), min=eps))[..., None]


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _make_frame(n):
    """Orthonormal frame rows (n, t1, t2) from normals n (..., 3)."""
    ez = torch.zeros_like(n)
    ez[..., 2] = 1.0
    ex = torch.zeros_like(n)
    ex[..., 0] = 1.0
    ref = torch.where(torch.abs(n[..., 2:3]) < 0.99, ez, ex)
    t1 = torch.linalg.cross(ref, n, dim=-1)
    t1 = t1 / torch.clamp(torch.linalg.norm(t1, dim=-1, keepdim=True),
                          min=1e-12)
    t2 = torch.linalg.cross(n, t1, dim=-1)
    return torch.stack([n, t1, t2], -2)


def _seg_seg(p1, q1, p2, q2):
    """Closest points between two segments (clamped-parameter form)."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = a * e - b * b
    s = torch.where(denom > 1e-12,
                    (b * f - c * e) / torch.clamp(denom, min=1e-12), 0.0)
    s = torch.clamp(s, 0.0, 1.0)
    t = torch.where(e > 1e-12, (b * s + f) / torch.clamp(e, min=1e-12), 0.0)
    t = torch.clamp(t, 0.0, 1.0)
    s = torch.where(a > 1e-12, torch.clamp(
        (b * t - c) / torch.clamp(a, min=1e-12), 0.0, 1.0), 0.0)
    return p1 + d1 * s[..., None], p2 + d2 * t[..., None]


def _point_box(pl, size):
    """Closest surface point + signed distance in the box frame; ``size``
    (P, 3) half extents. Tie faces are averaged."""
    cl = _clip(pl, -size, size)
    out_d = _norm(pl - cl)
    f = size - torch.abs(pl)
    dmin = torch.minimum(f[..., 0], torch.minimum(f[..., 1], f[..., 2]))
    is_out = out_d > 1e-12
    o = (f == dmin[..., None]).to(pl.dtype)
    cnt = torch.clamp(o[..., 0] + o[..., 1] + o[..., 2], min=1.0)
    o = o / cnt[..., None]
    proj = pl * (1 - o) + torch.where(pl >= 0, size, -size) * o
    closest = torch.where(is_out[..., None], cl, proj)
    dist = torch.where(is_out, out_d, -dmin)
    return closest, dist


def _smallest(vals, k):
    """Indices (..., k) of the k smallest along the last axis, ties to
    the lowest index (a stable sort, like the JAX package's masks)."""
    return torch.sort(vals, dim=-1, stable=True)[1][..., :k]


def _take(x, idx):
    """Gather samples: x (B, P, S[, 3]) at idx (B, P, k) -> (B, P, k[, 3])."""
    if x.dim() == idx.dim():
        return torch.gather(x, -1, idx)
    return torch.gather(x, -2, idx[..., None].expand(idx.shape + (3,)))


def _sample_major(x):
    """(B, P, S[, 3]) -> (B, S*P[, 3]): slot s of all pairs, then s+1."""
    if x.dim() == 3:
        return x.transpose(1, 2).reshape(x.shape[0], -1)
    return x.transpose(1, 2).reshape(x.shape[0], -1, 3)


# ---------------- per-model plan of static tensors ---------------------

def _capsule_entity_params(m, g, s):
    """Host-side (offset, local axis, radius, half-length) of the
    capsule entity for geom ``g`` (sub-capsule ``s`` >= 0, whole-mesh
    PCA proxy, or the primitive itself)."""
    mid = int(m.geom_meshid[g])
    if mid >= 0:
        from deepmimic_mujoco_tpu_torch.utils import hostquat as hq

        mesh = m.meshes[mid]
        if s >= 0:
            cp, cq, cr, ch = mesh.sub_capsules[int(s)]
            return np.asarray(cp), hq.to_mat(cq)[:, 2], cr, ch
        return (np.asarray(mesh.capsule_pos),
                hq.to_mat(mesh.capsule_quat)[:, 2],
                mesh.capsule_size[0], mesh.capsule_size[1])
    return (np.zeros(3), np.array([0.0, 0.0, 1.0]),
            float(m.geom_size[g][0]), float(m.geom_size[g][1]))


def _corners(size):
    """(P, 8, 3) box corners, x slowest (the JAX package's order)."""
    sg = np.array([(sx, sy, sz) for sx in (-1, 1) for sy in (-1, 1)
                   for sz in (-1, 1)], np.float64)
    return sg[None] * np.asarray(size)[:, None, :]


def _hull_verts(m, gids):
    """(P, Kv, 3) hull vertices of each mesh geom, padded to the largest
    count with the mesh's own first vertex (the JAX package's layout: a
    short mesh may offer the same vertex in several of its 4 slots)."""
    vs = [np.asarray(m.meshes[int(m.geom_meshid[g])].verts)
          for g in np.asarray(gids)]
    kv = max(len(v) for v in vs)
    out = np.zeros((len(vs), kv, 3))
    for i, v in enumerate(vs):
        out[i, :len(v)] = v
        out[i, len(v):] = v[0]
    return out


def _build_plan(m, tables, device, dtype):
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device,
                                  dtype=dtype)
    i = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    ent_index: Dict[tuple, int] = {}
    ent_keys = []

    def ent_ids(gids, subs):
        ids = []
        for g, s in zip(np.asarray(gids), np.asarray(subs)):
            k = (int(g), int(s))
            if k not in ent_index:
                ent_index[k] = len(ent_keys)
                ent_keys.append(k)
            ids.append(ent_index[k])
        return np.asarray(ids)

    groups = []
    for grp in tables:
        kind = grp.kind
        none = np.full(len(grp.g1), -1)
        p = dict(kind=kind, g1=i(grp.g1), g2=i(grp.g2))
        size1 = np.asarray(m.geom_size[np.asarray(grp.g1)])
        size2 = np.asarray(m.geom_size[np.asarray(grp.g2)])
        if kind in (K_PLANE_SPHERE, K_SPHERE_SPHERE, K_SPHERE_CAPSULE,
                    K_SPHERE_BOX):
            p["r1"] = f(size1[:, 0])
            p["r2"] = f(size2[:, 0])
        if kind == K_PLANE_CAPSULE:
            p["cap2"] = ent_ids(grp.g2, none)
        elif kind == K_SPHERE_CAPSULE:
            p["cap2"] = ent_ids(grp.g2, grp.sub2)
        elif kind == K_CAPSULE_CAPSULE:
            p["cap1"] = ent_ids(grp.g1, grp.sub1)
            p["cap2"] = ent_ids(grp.g2, grp.sub2)
        elif kind == K_CAPSULE_BOX:
            p["cap1"] = ent_ids(grp.g1, grp.sub1)
        if kind in (K_SPHERE_BOX, K_CAPSULE_BOX, K_BOX_BOX):
            p["size2"] = f(size2)
        if kind == K_PLANE_BOX:
            p["locs2"] = f(_corners(size2))
        if kind == K_PLANE_MESH:
            p["locs2"] = f(_hull_verts(m, grp.g2))
        if kind == K_BOX_BOX:
            p["size1"] = f(size1)
            p["corners1"] = f(_corners(size1))
            p["corners2"] = f(_corners(size2))
        groups.append(p)

    ent = None
    if ent_keys:
        pr = [_capsule_entity_params(m, g, s) for g, s in ent_keys]
        ent = dict(gid=i([g for g, _ in ent_keys]),
                   off=f([q[0] for q in pr]), ax=f([q[1] for q in pr]),
                   rad=f([q[2] for q in pr]), half=f([q[3] for q in pr]))
        for p in groups:
            for side in ("cap1", "cap2"):
                if side in p:
                    p[side] = i(p[side])

    cat = lambda key: np.concatenate(
        [np.tile(getattr(g, key), _SLOTS[g.kind]) if key in ("g1", "g2")
         else getattr(g, key) for g in tables])
    gap = np.concatenate([g.gap for g in tables])
    meta = dict(g1=i(cat("g1")), g2=i(cat("g2")), margin=f(cat("margin")),
                friction=f(cat("friction")), solref=f(cat("solref")),
                solimp=f(cat("solimp")), condim=i(cat("condim")),
                gap=f(gap) if np.any(gap < 0) else None)
    return dict(groups=groups, ent=ent, meta=meta)


def _plan(m, tables, device, dtype):
    cache = m.__dict__.setdefault("_torch_consts", {})
    key = ("collide_plan", id(tables), str(device), dtype)
    hit = cache.get(key)
    # the entry holds ``tables`` itself, so its id cannot be reused
    if hit is None or hit[0] is not tables:
        hit = (tables, _build_plan(m, tables, device, dtype))
        cache[key] = hit
    return hit[1]


# ---------------- narrow phase ---------------------------------------

def _narrow_groups(m, tables: List[PairGroup], kin: Kin):
    """Per-group (dist (B, S*P), pos (B, S*P, 3), nrm (B, S*P, 3)),
    flattened SAMPLE-MAJOR (matching the metadata tiling in
    build_pair_tables)."""
    x = kin.geom_xpos
    plan = _plan(m, tables, x.device, x.dtype)
    GP, GR = kin.geom_xpos, kin.geom_xmat

    ent = plan["ent"]
    if ent is not None:
        Pe, Re = GP[:, ent["gid"]], GR[:, ent["gid"]]
        center = Pe + _rot(Re, ent["off"])
        axis = _rot(Re, ent["ax"])
        ax_h = axis * ent["half"][:, None]
        ep0, ep1 = center - ax_h, center + ax_h

    def cap(ids):
        return ep0[:, ids], ep1[:, ids], ent["rad"][ids]

    out = []
    for p in plan["groups"]:
        kind, g1, g2 = p["kind"], p["g1"], p["g2"]

        if kind in (K_PLANE_SPHERE, K_PLANE_CAPSULE, K_PLANE_BOX,
                    K_PLANE_MESH):
            n, pp = GR[:, g1, :, 2], GP[:, g1]
            if kind == K_PLANE_SPHERE:
                c, r = GP[:, g2], p["r2"]
                d = _dot(c - pp, n) - r
                out.append((d, c - n * (r + d / 2)[..., None], n))
            elif kind == K_PLANE_CAPSULE:
                c0, c1, r = cap(p["cap2"])
                ds, cps = [], []
                for end in (c1, c0):   # (+axis, -axis) end order
                    dk = _dot(end - pp, n) - r
                    ds.append(dk)
                    cps.append(end - n * (r + dk / 2)[..., None])
                out.append((torch.cat(ds, 1), torch.cat(cps, 1),
                            n.repeat(1, 2, 1)))
            else:
                fp, fR = GP[:, g2], GR[:, g2]
                # box corners or hull vertices against the plane:
                # h = (c - pp)·n + v·(R^T n), pair-level base + local
                # points; the 4 lowest, ties to the lowest index
                base = _dot(fp - pp, n)
                w = _rot_t(fR, n)
                lv = p["locs2"]                              # (P, Kv, 3)
                hs = base[..., None] + _dot(lv, w[:, :, None, :])
                pts = fp[:, :, None, :] + _rot(fR[:, :, None], lv)
                sel = _smallest(hs, 4)
                dj, pj = _take(hs, sel), _take(pts, sel)
                out.append((_sample_major(dj),
                            _sample_major(pj - n[:, :, None, :]
                                          * (dj / 2)[..., None]),
                            n.repeat(1, 4, 1)))
            continue

        if kind == K_SPHERE_SPHERE:
            c1, c2, r1, r2 = GP[:, g1], GP[:, g2], p["r1"], p["r2"]
            dvec = c2 - c1
            nrm = _normalized(dvec)
            d = _norm(dvec) - (r1 + r2)
            out.append((d, c1 + nrm * (r1 + d / 2)[..., None], nrm))
            continue

        if kind == K_SPHERE_CAPSULE:
            c1, r1 = GP[:, g1], p["r1"]
            p0, p1, rad = cap(p["cap2"])
            seg = p1 - p0
            e = _dot(seg, seg)
            t = torch.clamp(torch.where(
                e > 1e-12, _dot(c1 - p0, seg) / torch.clamp(e, min=1e-12),
                0.0), 0.0, 1.0)
            dvec = p0 + seg * t[..., None] - c1
            nrm = _normalized(dvec)
            d = _norm(dvec) - (r1 + rad)
            out.append((d, c1 + nrm * (r1 + d / 2)[..., None], nrm))
            continue

        if kind == K_CAPSULE_CAPSULE:
            a0, a1, ra = cap(p["cap1"])
            b0, b1, rb = cap(p["cap2"])
            ca, cb = _seg_seg(a0, a1, b0, b1)
            dvec = cb - ca
            nrm = _normalized(dvec)
            d = _norm(dvec) - (ra + rb)
            out.append((d, ca + nrm * (ra + d / 2)[..., None], nrm))
            continue

        if kind == K_SPHERE_BOX:
            c1, r1 = GP[:, g1], p["r1"]
            fp, fR = GP[:, g2], GR[:, g2]
            closest, dsurf = _point_box(_rot_t(fR, c1 - fp), p["size2"])
            cw = fp + _rot(fR, closest)
            nrm = _normalized(cw - c1)
            nrm = nrm * torch.where(dsurf < 0, -1.0, 1.0)[..., None]
            d = dsurf - r1
            out.append((d, cw - nrm * (d / 2)[..., None], nrm))
            continue

        if kind == K_CAPSULE_BOX:
            p0, p1, rad = cap(p["cap1"])
            fp, fR = GP[:, g2], GR[:, g2]
            p0l = _rot_t(fR, p0 - fp)
            dl = _rot_t(fR, p1 - p0)
            S = 8
            tv = const(m, "capsule_box_t", lambda: np.asarray(
                [k / (S - 1.0) for k in range(S)]), x.device, x.dtype)
            plk = p0l[:, :, None, :] + dl[:, :, None, :] * tv[:, None]
            ck, dk = _point_box(plk, p["size2"][:, None, :])  # (B, P, S)
            sel = _smallest(dk, 1)
            dbest = _take(dk, sel)[..., 0]
            clbest = _take(ck, sel)[:, :, 0]
            tbest = tv[sel[..., 0]]
            pbest = p0 + (p1 - p0) * tbest[..., None]
            cw = fp + _rot(fR, clbest)
            nrm = _normalized(cw - pbest)
            nrm = nrm * torch.where(dbest < 0, -1.0, 1.0)[..., None]
            d = dbest - rad
            out.append((d, cw - nrm * (d / 2)[..., None], nrm))
            continue

        if kind == K_BOX_BOX:
            fa = (GP[:, g1], GR[:, g1], p["corners1"], p["size1"])
            fb = (GP[:, g2], GR[:, g2], p["corners2"], p["size2"])

            def corners_vs(src, dst):
                sp, sR, corners, _ = src
                dp, dR, _, dsize = dst
                pw = sp[:, :, None, :] + _rot(sR[:, :, None], corners)
                pl = _rot_t(dR[:, :, None], pw - dp[:, :, None])
                ck, dk = _point_box(pl, dsize[:, None, :])
                return pw, dp[:, :, None, :] + _rot(dR[:, :, None], ck), dk

            ptsA, cwA, dA = corners_vs(fa, fb)
            ptsB, cwB, dB = corners_vs(fb, fa)
            pts = torch.cat([ptsA, ptsB], 2)
            cws = torch.cat([cwA, cwB], 2)
            dss = torch.cat([dA, dB], 2)
            flips = torch.cat([torch.ones_like(dA), -torch.ones_like(dB)], 2)
            sel = _smallest(dss, 4)
            dj, pj, cj = _take(dss, sel), _take(pts, sel), _take(cws, sel)
            fj = _take(flips, sel)
            nrm = _normalized((cj - pj) * fj[..., None])
            nrm = nrm * torch.where(dj < 0, -1.0, 1.0)[..., None]
            out.append((_sample_major(dj), _sample_major((pj + cj) * 0.5),
                        _sample_major(nrm)))
            continue

        raise NotImplementedError(kind)
    return out


# ---------------- main entry ------------------------------------------

def collide(m: PhysicsModel, tables: List[PairGroup], kin: Kin,
            max_contacts: int) -> Contacts:
    """Narrow phase over all groups, then top-K deepest selection."""
    meta = _plan(m, tables, kin.xpos.device, kin.xpos.dtype)["meta"]
    groups = _narrow_groups(m, tables, kin)
    dist = torch.cat([g[0] for g in groups], 1)
    pos = torch.cat([g[1] for g in groups], 1)
    normal = torch.cat([g[2] for g in groups], 1)
    if meta["gap"] is not None:
        dist = dist - meta["gap"]   # widen proxy rest gaps

    margin = meta["margin"]
    depth = dist - margin
    k = min(max_contacts, dist.shape[1])
    # lax.top_k of -(dist - margin): deepest first, ties to the lower
    # slot index; the slot order keys the warm-start gather
    idx = _smallest(depth, k)                                  # (B, k)
    overflow = torch.clamp((depth < 0.0).sum(1) - k, min=0)
    take3 = lambda a: torch.gather(a, 1, idx[..., None].expand(-1, -1, 3))
    return Contacts(
        dist=torch.gather(dist, 1, idx),
        pos=take3(pos),
        frame=_make_frame(take3(normal)),
        geom1=meta["g1"][idx],
        geom2=meta["g2"][idx],
        includemargin=margin[idx],
        friction=meta["friction"][idx],
        solref=meta["solref"][idx],
        solimp=meta["solimp"][idx],
        condim=meta["condim"][idx],
        overflow=overflow,
        slot_idx=idx,
    )
