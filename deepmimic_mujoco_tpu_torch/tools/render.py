"""Host-side rendering: FK on the card, frames from the native ray tracer.

The port of the JAX package's ``tools/render.py``. ``render_state`` runs
the port's FK (``physics.kinematics.fwd_kinematics``) on ``device``,
brings only the geom poses back to the host and draws them with the ray
tracer of ``native/`` (host C++, OpenMP; ``draw_poses``). Mesh geoms
are ray-traced as their convex hulls (scipy), or as their PCA proxy
capsules where scipy's hull is unavailable. Without g++ on the PATH the
frame is a matplotlib sketch. ``mode="rgb_array"`` returns an HxWx3
uint8 frame, with the overlay text drawn by ``cv2.putText``;
``frames_to_video`` writes an mp4 with ``cv2.VideoWriter``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from deepmimic_mujoco_tpu_torch.models.physics_model import (
    BOX, CAPSULE, CYLINDER, MESH, PLANE, SPHERE,
)
from deepmimic_mujoco_tpu_torch.utils import hostquat as hq


def _mesh_hull_tris(mesh):
    """(nt, 3, 3) triangle soup of the mesh's decimated hull vertex set
    (already in the geom frame). None if scipy's hull is unavailable."""
    try:
        from scipy.spatial import ConvexHull, QhullError
    except ImportError:
        return None
    try:
        hull = ConvexHull(np.asarray(mesh.verts, np.float64))
    except QhullError:
        return None
    return np.asarray(mesh.verts, np.float32)[hull.simplices]


def _scene_tables(model):
    """Static per-geom tables, built once and kept on the model: (type,
    size, rgba, proxy pos, proxy quat, hull triangles, triangle offset,
    triangle count, mesh AABB half-extent)."""
    cache = model.__dict__.setdefault("_render_tables", {})
    if "scene" in cache:
        return cache["scene"]
    ngeom = model.ngeom
    gtype = np.zeros(ngeom, np.int32)
    size = np.asarray(model.geom_size, np.float32).copy()
    rgba = np.zeros((ngeom, 4), np.float32)
    proxy_pos = np.zeros((ngeom, 3), np.float32)
    proxy_quat = np.tile(np.array([1, 0, 0, 0], np.float32), (ngeom, 1))
    tri_off = np.zeros(ngeom, np.int32)
    tri_cnt = np.zeros(ngeom, np.int32)
    mesh_aabb = np.zeros((ngeom, 3), np.float32)
    tri_chunks = []
    ntri_total = 0
    palette = np.array([
        [0.76, 0.60, 0.42, 1.0],  # body tan
        [0.55, 0.55, 0.62, 1.0],  # metal
    ], np.float32)
    hull_cache = {}
    for g in range(ngeom):
        t = int(model.geom_type[g])
        if t == MESH:
            mid = int(model.geom_meshid[g])
            mesh = model.meshes[mid]
            if mid not in hull_cache:
                hull_cache[mid] = _mesh_hull_tris(mesh)
            tris = hull_cache[mid]
            if tris is not None:
                # hull triangles in the geom frame (the geom frame is
                # the mesh's principal frame after MJCF compilation)
                gtype[g] = MESH
                tri_off[g] = ntri_total
                tri_cnt[g] = len(tris)
                mesh_aabb[g] = np.abs(
                    np.asarray(mesh.verts)).max(0) * 1.02 + 1e-3
                tri_chunks.append(tris.reshape(-1, 9))
                ntri_total += len(tris)
            else:  # no hull: the PCA proxy capsule
                gtype[g] = CAPSULE
                size[g, 0] = mesh.capsule_size[0]
                size[g, 1] = mesh.capsule_size[1]
                proxy_pos[g] = mesh.capsule_pos
                proxy_quat[g] = mesh.capsule_quat
            rgba[g] = palette[1]
        else:
            gtype[g] = t
            rgba[g] = palette[0] if t != PLANE else np.array(
                [0.45, 0.62, 0.45, 1.0], np.float32)
    tri_verts = (np.concatenate(tri_chunks, axis=0) if tri_chunks
                 else np.zeros((1, 9), np.float32))
    tables = (gtype, size, rgba, proxy_pos, proxy_quat,
              np.ascontiguousarray(tri_verts, np.float32), tri_off,
              tri_cnt, mesh_aabb)
    cache["scene"] = tables
    return tables


def geom_poses(model, qpos, device="cuda"):
    """FK of one qpos on ``device``; returns the host float32 geom
    positions (ngeom, 3) and rotation matrices (ngeom, 3, 3)."""
    from deepmimic_mujoco_tpu_torch.physics.kinematics import (
        fwd_kinematics,
    )

    q = torch.as_tensor(qpos, dtype=torch.float32, device=device)
    with torch.no_grad():
        kin = fwd_kinematics(model, q.reshape(1, -1))
    return (kin.geom_xpos[0].cpu().numpy(),
            kin.geom_xmat[0].cpu().numpy())


def draw_poses(model, geom_xpos, geom_xmat, root, overlay: str = "",
               width: int = 480, height: int = 480,
               azimuth_deg: float = 155.0, distance: float = 3.0):
    """The frame (height, width, 3) uint8 of the given geom poses, with
    the camera orbiting ``root`` (the root position, or zeros)."""
    (gtype, size, rgba, proxy_pos, proxy_quat, tri_verts, tri_off,
     tri_cnt, mesh_aabb) = _scene_tables(model)
    gx = np.asarray(geom_xpos, np.float32)
    gm = np.asarray(geom_xmat, np.float32)
    # the ray tracer reads ngeom rows of each, and width x height pixels
    if gx.shape != (model.ngeom, 3) or gm.shape != (model.ngeom, 3, 3):
        raise ValueError(f"geom poses of shapes {gx.shape}, {gm.shape} for "
                         f"a model of {model.ngeom} geoms")
    if width < 1 or height < 1:
        raise ValueError(f"frame of {width}x{height} pixels")
    # fold the proxy transforms into world frames (identity for hull
    # meshes and primitives)
    pos = gx + np.einsum("nij,nj->ni", gm, proxy_pos)
    mats = gm @ hq.to_mat(proxy_quat.astype(np.float64)).astype(np.float32)

    root = np.asarray(root, np.float32)
    az = np.deg2rad(azimuth_deg)
    cam = (root + np.array([np.cos(az) * distance, np.sin(az) * distance,
                            1.0], np.float32)).astype(np.float32)
    tgt = (root + np.array([0, 0, 0.2], np.float32)).astype(np.float32)

    from deepmimic_mujoco_tpu_torch.native import rasterizer_lib

    lib = rasterizer_lib()
    if lib is not None:
        frame = np.zeros((height, width, 3), np.uint8)
        args = [np.ascontiguousarray(a, dt) for a, dt in (
            (pos, np.float32), (mats, np.float32), (gtype, np.int32),
            (size, np.float32), (rgba, np.float32), (tri_verts, np.float32),
            (tri_off, np.int32), (tri_cnt, np.int32),
            (mesh_aabb, np.float32), (cam, np.float32), (tgt, np.float32))]
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        ptr = [a.ctypes.data_as(ip if a.dtype == np.int32 else fp)
               for a in args]
        lib.render_scene_mesh(
            *ptr[:5], ctypes.c_int(model.ngeom), *ptr[5:],
            ctypes.c_float(55.0), ctypes.c_int(width), ctypes.c_int(height),
            frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    else:
        frame = _matplotlib_fallback(model, pos, mats, gtype, size, root,
                                     width, height)

    if overlay:
        import cv2

        cv2.putText(frame, overlay, (16, 28), cv2.FONT_HERSHEY_SIMPLEX,
                    0.7, (255, 255, 255), 2, cv2.LINE_AA)
    return frame


def render_state(model, qpos, mode: Optional[str] = None,
                 overlay: str = "", width: int = 480, height: int = 480,
                 azimuth_deg: float = 155.0, distance: float = 3.0,
                 device="cuda"):
    """Frame of one state ``qpos`` (numpy or a tensor), FK on
    ``device``. ``mode`` "rgb_array" or None returns it; "human" shows
    it in a matplotlib window."""
    gx, gm = geom_poses(model, qpos, device)
    q = torch.as_tensor(qpos, dtype=torch.float32).cpu().numpy()
    root = q[:3] if model.nq >= 3 else np.zeros(3, np.float32)
    frame = draw_poses(model, gx, gm, root, overlay, width, height,
                       azimuth_deg, distance)
    if mode in ("rgb_array", None):
        return frame
    if mode == "human":  # pragma: no cover - interactive
        import matplotlib.pyplot as plt

        plt.imshow(frame)
        plt.pause(0.001)
        return None
    raise ValueError(f"unknown render mode {mode}")


def _matplotlib_fallback(model, pos, mats, gtype, size, root,
                         width, height):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(width / 100, height / 100), dpi=100)
    ax = fig.add_subplot(111, projection="3d")
    for g in range(model.ngeom):
        if gtype[g] == PLANE:
            continue
        c = pos[g]
        if gtype[g] == SPHERE:
            ax.scatter(*c, s=(size[g, 0] * 400) ** 2 * 0.25,
                       color="tab:brown")
        elif gtype[g] in (CAPSULE, CYLINDER):
            axis = mats[g][:, 2] * size[g, 1]
            ax.plot(*zip(c - axis, c + axis), lw=max(1, size[g, 0] * 90),
                    color="tab:brown", solid_capstyle="round")
        elif gtype[g] == BOX:
            ax.scatter(*c, s=40, color="tab:orange", marker="s")
    ax.set_xlim(root[0] - 1.2, root[0] + 1.2)
    ax.set_ylim(root[1] - 1.2, root[1] + 1.2)
    ax.set_zlim(0, 2.2)
    ax.set_axis_off()
    fig.canvas.draw()
    buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    w, h = fig.canvas.get_width_height()
    plt.close(fig)
    return buf.reshape(h, w, 4)[..., :3].copy()


def frames_to_video(frames, path, fps: int = 24):
    """Write the frames as an mp4 (``mp4v``), as the reference writes its
    eval dashboard videos with OpenCV (src/sb3_ppo.py:86-99)."""
    import cv2

    h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                          fps if len(frames) > 10 else 1, (w, h))
    for f in frames:
        out.write(f[..., ::-1])  # rgb -> bgr
    out.release()
    return path
