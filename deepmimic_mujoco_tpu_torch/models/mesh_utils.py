"""Host-side mesh processing for collision proxies and frame centering.

The engine never touches raw triangles at runtime: at build time each
collision mesh is reduced to (a) a bounded convex-hull vertex set used
for exact plane contacts and (b) a PCA-fitted capsule proxy used for
mesh-vs-primitive contacts. Mirrors what the reference gets from the
native engine's mesh pipeline (convex hulls compiled into the model).

Also replicates the engine-compiler behavior of re-expressing a mesh in
its volume-centroid / principal-axis frame, folding the transform into
``geom_pos``/``geom_quat`` — required for geom_xpos parity with models
compiled from the same MJCF.
"""
from __future__ import annotations

import struct

import numpy as np


def load_stl(path: str) -> np.ndarray:
    """Read an STL file, returning (ntri, 3, 3) vertex array."""
    with open(path, "rb") as f:
        data = f.read()
    # ASCII STL starts with 'solid' and contains 'facet'
    if data[:5] == b"solid" and b"facet" in data[:200]:
        return _load_stl_ascii(data)
    ntri = struct.unpack_from("<I", data, 80)[0]
    tris = np.frombuffer(
        data, dtype=np.dtype([("n", "<3f4"), ("v", "<(3,3)f4"), ("attr", "<u2")]),
        count=ntri, offset=84,
    )
    return tris["v"].astype(np.float64)


def _load_stl_ascii(data: bytes) -> np.ndarray:
    verts = []
    for line in data.decode("ascii", "ignore").splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            verts.append([float(x) for x in line.split()[1:4]])
    v = np.asarray(verts, dtype=np.float64)
    return v.reshape(-1, 3, 3)


def volume_centroid_inertia(tris: np.ndarray, legacy: bool = False):
    """Solid volume, centroid and unit-density inertia of a mesh.

    ``legacy=False``: signed tetrahedron decomposition against the
    origin (exact for closed surfaces). ``legacy=True``: reproduces the
    engine compiler's default ("legacy") mesh processing — tetrahedra
    rooted at the area-weighted surface centroid with **absolute**
    volumes, which tolerates non-watertight CAD meshes.
    Returns (volume, centroid(3,), inertia(3,3) about centroid).
    """
    tris = np.asarray(tris, dtype=np.float64)
    if legacy:
        a0, b0, c0 = tris[:, 0], tris[:, 1], tris[:, 2]
        area = 0.5 * np.linalg.norm(np.cross(b0 - a0, c0 - a0), axis=1)
        facecen = ((a0 + b0 + c0) / 3.0 * area[:, None]).sum(0) / area.sum()
        tris = tris - facecen
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        det = np.abs(np.einsum("ij,ij->i", a, np.cross(b, c)))
        vol = det.sum() / 6.0
        centroid_local = ((a + b + c) * det[:, None]).sum(0) / (24.0 * vol)
        P = np.zeros((3, 3))
        for i in range(3):
            for j in range(3):
                vi = np.stack([a[:, i], b[:, i], c[:, i]], 1)
                vj = np.stack([a[:, j], b[:, j], c[:, j]], 1)
                s = (vi.sum(1) * vj.sum(1) + (vi * vj).sum(1)) / 120.0
                P[i, j] = (det * s).sum()
        P = P - vol * np.outer(centroid_local, centroid_local)
        inertia = np.trace(P) * np.eye(3) - P
        return vol, facecen + centroid_local, inertia
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    det = np.einsum("ij,ij->i", a, np.cross(b, c))  # 6 * signed tet volume
    vol = det.sum() / 6.0
    centroid = ((a + b + c) * det[:, None]).sum(0) / (24.0 * vol)
    # inertia via canonical tetra integrals
    # for tetra (0, a, b, c): integral of x_i x_j over tet
    # I'll accumulate second moments sum(x^2), sum(xy) etc.
    def moment2(pa, pb, pc, i, j):
        # integral over tetra(0,a,b,c) of x_i*x_j dV =
        # detJ/120 * (2*sum_k a_k[i]a_k[j] + sum_{k!=l} a_k[i]a_l[j])
        vi = np.stack([pa[:, i], pb[:, i], pc[:, i]], 1)
        vj = np.stack([pa[:, j], pb[:, j], pc[:, j]], 1)
        s = (vi.sum(1) * vj.sum(1) + (vi * vj).sum(1)) / 120.0
        return det * s

    P = np.zeros((3, 3))
    for i in range(3):
        for j in range(3):
            P[i, j] = moment2(a, b, c, i, j).sum()
    # shift to centroid: P_c = P - V * c c^T
    P = P - vol * np.outer(centroid, centroid)
    inertia = np.trace(P) * np.eye(3) - P
    return vol, centroid, inertia


def hull_tris(tris: np.ndarray) -> np.ndarray:
    """Outward-oriented convex-hull triangle soup of a mesh."""
    verts = np.unique(tris.reshape(-1, 3), axis=0)
    from scipy.spatial import ConvexHull

    hull = ConvexHull(verts)
    t = verts[hull.simplices]  # (nt, 3, 3)
    inner = verts.mean(0)
    n = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
    flip = np.einsum("ij,ij->i", n, t[:, 0] - inner) < 0
    t[flip] = t[flip][:, ::-1]
    return t


def principal_frame(tris: np.ndarray):
    """(centroid, quat_wxyz) of the volume-centroid principal frame.

    Matches the engine compiler's default ("legacy") mesh processing;
    falls back to vertex statistics when the volume is degenerate.
    """
    from deepmimic_mujoco_tpu_torch.utils import hostquat as hq

    vol, centroid, inertia = volume_centroid_inertia(tris, legacy=True)
    verts = tris.reshape(-1, 3)
    if not np.isfinite(vol) or abs(vol) < 1e-12:
        centroid = verts.mean(0)
        d = verts - centroid
        inertia = np.eye(3) * d.var()
    w, v = np.linalg.eigh(inertia)  # ascending
    # order axes by descending eigenvalue (largest moment = x), mirroring
    # the engine-compiler convention; enforce right-handedness.
    order = np.argsort(w)[::-1]
    R = v[:, order]
    if np.linalg.det(R) < 0:
        R[:, 2] *= -1
    quat = hq.from_mat(R)
    return centroid, quat


def hull_vertices(tris: np.ndarray, max_verts: int = 32) -> np.ndarray:
    """Convex hull vertex set, greedily subsampled to ``max_verts``."""
    verts = np.unique(tris.reshape(-1, 3), axis=0)
    try:
        from scipy.spatial import ConvexHull

        hull = ConvexHull(verts)
        hv = verts[hull.vertices]
    except Exception:
        hv = verts
    if len(hv) <= max_verts:
        return hv
    # farthest-point subsampling keeps the extremes (what plane contacts
    # and support functions care about)
    chosen = [int(np.argmax(np.linalg.norm(hv - hv.mean(0), axis=1)))]
    d = np.linalg.norm(hv - hv[chosen[0]], axis=1)
    for _ in range(max_verts - 1):
        nxt = int(np.argmax(d))
        chosen.append(nxt)
        d = np.minimum(d, np.linalg.norm(hv - hv[nxt], axis=1))
    return hv[chosen]


def fit_capsule(verts: np.ndarray):
    """PCA capsule fit: (pos, quat_wxyz, radius, half_length).

    Axis = principal direction of the vertex cloud; radius covers the
    max perpendicular distance; the capsule's z-axis is the fit axis.
    """
    from deepmimic_mujoco_tpu_torch.utils import hostquat as hq

    c = verts.mean(0)
    d = verts - c
    _, _, vt = np.linalg.svd(d, full_matrices=False)
    axis = vt[0]
    t = d @ axis
    perp = d - t[:, None] * axis[None]
    radius = float(np.linalg.norm(perp, axis=1).max())
    radius = max(radius, 1e-4)
    tmin, tmax = float(t.min()), float(t.max())
    mid = c + axis * (tmin + tmax) / 2.0
    half = max((tmax - tmin) / 2.0 - radius, 1e-4)
    # quaternion rotating +z to axis
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(z, axis)
    s = np.linalg.norm(v)
    if s < 1e-12:
        quat = np.array([1.0, 0, 0, 0]) if axis[2] > 0 else np.array([0.0, 1, 0, 0])
    else:
        ang = float(np.arctan2(s, float(z @ axis)))
        quat = hq.from_axis_angle(v / s, np.asarray(ang))
    return mid, quat, radius, half


def _support_error(verts, caps, dirs):
    """Mean outward protrusion of a capsule union beyond the hull,
    measured by support functions over sample directions."""
    from deepmimic_mujoco_tpu_torch.utils import hostquat as hq

    h_hull = (dirs @ verts.T).max(1)
    sup = []
    for pos, quat, r, h in caps:
        axis = hq.to_mat(np.asarray(quat))[:, 2]
        sup.append(dirs @ np.asarray(pos) + np.abs(dirs @ axis) * h + r)
    return np.maximum(np.max(sup, axis=0) - h_hull, 0.0).mean()


def fit_capsules_adaptive(verts: np.ndarray, k: int = 2, n_dirs: int = 64):
    """fit_capsules, but keep the decomposition only if it is a
    measurably tighter over-approximation than the single PCA capsule
    (it wins on elongated links — G1 knee/hip-yaw — and loses on
    compact ones like the pelvis, where the split's endcap protrusion
    dominates)."""
    single = [fit_capsule(verts)]
    multi = fit_capsules(verts, k)
    if len(multi) < 2:
        return single
    rng = np.random.default_rng(12345)
    dirs = rng.normal(size=(n_dirs, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    e1 = _support_error(verts, single, dirs)
    e2 = _support_error(verts, multi, dirs)
    return multi if e2 < 0.95 * e1 else single


def fit_capsules(verts: np.ndarray, k: int):
    """Multi-capsule PCA fit: split the hull-vertex cloud into ``k``
    equal-count segments along its principal axis and fit one capsule
    per segment (fit_capsule semantics each). A single fat capsule
    over-approximates elongated/L-shaped links (G1 shins, forearms),
    producing false self-contacts in collapse poses; per-segment
    capsules track the geometry much closer. Returns a list of
    (pos, quat_wxyz, radius, half_length).
    """
    verts = np.asarray(verts, np.float64)
    if k <= 1 or len(verts) < 2 * k:
        return [fit_capsule(verts)]
    c = verts.mean(0)
    d = verts - c
    _, _, vt = np.linalg.svd(d, full_matrices=False)
    t = d @ vt[0]
    order = np.argsort(t)
    out = []
    # overlapping segments (one-third overlap) so the union stays a
    # cover of the hull across the split planes
    bounds = np.linspace(0, len(verts), k + 1).astype(int)
    for i in range(k):
        lo = max(bounds[i] - len(verts) // (3 * k), 0)
        hi = min(bounds[i + 1] + len(verts) // (3 * k), len(verts))
        out.append(fit_capsule(verts[order[lo:hi]]))
    return out
