"""MJCF parser: XML robot description → :class:`PhysicsModel`.

A from-scratch model compiler covering the MJCF subset used by the
DeepMimic humanoid3d and Unitree G1 models (reference assets:
src/mujoco/humanoid_deepmimic/envs/asset/*.xml):

- nested default classes with ``childclass`` scoping,
- bodies / free+hinge joints / sphere, capsule, box, plane, cylinder and
  mesh geoms (``fromto`` supported),
- explicit ``<inertial>`` or inertia-from-geom computation (exact solid
  inertias for sphere/capsule/box/cylinder),
- mesh loading with volume-centroid/principal-axis re-centering folded
  into the geom frame (matching engine-compiler behavior),
- actuators (motor), contact excludes, keyframes, site sensors, options,
- static collision-pair enumeration (contype/conaffinity masks,
  same-body and parent-child filtering, excludes).

Validated field-by-field against the MuJoCo compiler in
tests/test_mjcf_parity.py (the oracle is used in tests only; the
runtime never imports it).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from reference.models import mesh_utils
from reference.models.physics_model import (
    BOX, CAPSULE, CYLINDER, EULER, FREE, GEOM_TYPE_NAMES, HINGE, MESH,
    PLANE, RK4, SPHERE, Mesh, Option, PhysicsModel,
)
from reference.utils import hostquat as hq

_DEFAULT_SOLREF = (0.02, 1.0)
_DEFAULT_SOLIMP = (0.9, 0.95, 0.001, 0.5, 2.0)


def _floats(s: str) -> np.ndarray:
    return np.array([float(x) for x in s.split()], dtype=np.float64)


def _euler_to_quat_xyz_extrinsic(e: np.ndarray) -> np.ndarray:
    """MJCF default eulerseq 'xyz': R = Rz(e2) @ Ry(e1) @ Rx(e0)? No —
    MJCF applies the rotations in sequence about the axes of the frame
    obtained so far: q = qx(e0) * qy(e1) * qz(e2) composed right-to-left
    in parent coordinates, equivalent to intrinsic xyz."""
    return hq.euler_to_quat_intrinsic(e, "xyz")


class _Defaults:
    """Nested default-class resolver."""

    def __init__(self):
        # class name -> {element tag -> {attr -> value}}
        self.classes: Dict[str, Dict[str, Dict[str, str]]] = {"main": {}}
        self.parent: Dict[str, Optional[str]] = {"main": None}

    def add_tree(self, elem: ET.Element, parent_class: str = "main"):
        name = elem.get("class", parent_class if elem.tag != "default" else None)
        if elem.tag == "default":
            name = elem.get("class", "main")
            if name not in self.classes:
                self.classes[name] = {}
                self.parent[name] = parent_class if name != "main" else None
            for child in elem:
                if child.tag == "default":
                    self.add_tree(child, name)
                else:
                    d = self.classes[name].setdefault(child.tag, {})
                    d.update(child.attrib)

    def resolve(self, tag: str, attrib: Dict[str, str], cls: str) -> Dict[str, str]:
        """Element attributes with class-default fallback (nearest wins)."""
        out: Dict[str, str] = {}
        chain: List[str] = []
        c: Optional[str] = cls
        while c is not None and c in self.classes:
            chain.append(c)
            c = self.parent.get(c)
        if "main" not in chain and "main" in self.classes:
            chain.append("main")
        for c in reversed(chain):  # root first, nearest class overrides
            out.update(self.classes[c].get(tag, {}))
        out.update(attrib)
        return out


class _Builder:
    def __init__(self, path: str):
        self.path = path
        self.dirname = os.path.dirname(os.path.abspath(path))
        self.defaults = _Defaults()
        self.meshdir = ""
        self.angle = "degree"  # MJCF default

        self.bodies: List[dict] = []
        self.joints: List[dict] = []
        self.geoms: List[dict] = []
        self.sites: List[dict] = []
        self.actuators: List[dict] = []
        self.mesh_files: Dict[str, str] = {}
        self.meshes: List[Mesh] = []
        self.mesh_frames: Dict[str, tuple] = {}  # name -> (centroid, quat)
        self.mesh_aabb: Dict[str, np.ndarray] = {}  # name -> half extents
        self.mesh_ids: Dict[str, int] = {}
        self.excludes: List[tuple] = []
        self.key_qpos: Optional[np.ndarray] = None
        self.sensors: List[tuple] = []
        self.opt = Option()
        self.nconmax = -1

    # ---------------- top-level parse ---------------------------------
    def parse(self) -> PhysicsModel:
        root = ET.parse(self.path).getroot()
        comp = root.find("compiler")
        if comp is not None:
            self.angle = comp.get("angle", "degree")
            self.meshdir = comp.get("meshdir", "")
            self.inertiafromgeom = comp.get("inertiafromgeom", "auto")
        else:
            self.inertiafromgeom = "auto"

        for d in root.findall("default"):
            self.defaults.add_tree(d)

        opt = root.find("option")
        if opt is not None:
            integ = {"Euler": EULER, "RK4": RK4, "implicit": EULER,
                     "implicitfast": EULER}[opt.get("integrator", "Euler")]
            grav = opt.get("gravity")
            self.opt = Option(
                timestep=float(opt.get("timestep", 0.002)),
                gravity=tuple(_floats(grav)) if grav else (0.0, 0.0, -9.81),
                integrator=integ,
                iterations=int(opt.get("iterations", 100)),
            )
        size = root.find("size")
        if size is not None:
            self.nconmax = int(size.get("nconmax", -1))

        for asset in root.findall("asset"):
            for mesh in asset.findall("mesh"):
                fname = mesh.get("file")
                name = mesh.get("name", os.path.splitext(os.path.basename(fname))[0])
                self.mesh_files[name] = os.path.join(self.dirname, self.meshdir, fname)

        # world body
        world = root.find("worldbody")
        self.bodies.append(dict(
            name="world", parentid=-1, pos=np.zeros(3), quat=np.array([1.0, 0, 0, 0]),
            cls="main", inertial=None, jntadr=[], geomadr=[],
        ))
        self._parse_body_children(world, 0, "main")

        # actuators
        act_root = root.find("actuator")
        if act_root is not None:
            for motor in act_root:
                a = self.defaults.resolve("motor", motor.attrib, motor.get("class", "main"))
                self.actuators.append(dict(
                    name=a.get("name", a["joint"]),
                    joint=a["joint"],
                    gear=float(a.get("gear", "1 0 0 0 0 0").split()[0]),
                    ctrlrange=_floats(a.get("ctrlrange", "0 0")),
                    ctrllimited=a.get("ctrllimited", "false").lower() == "true",
                ))

        contact = root.find("contact")
        if contact is not None:
            for ex in contact.findall("exclude"):
                self.excludes.append((ex.get("body1"), ex.get("body2")))

        sensor = root.find("sensor")
        if sensor is not None:
            for s in sensor:
                self.sensors.append((s.tag, s.get("site", s.get("objname", ""))))

        key = root.find("keyframe")
        if key is not None:
            k = key.find("key")
            if k is not None and k.get("qpos"):
                self.key_qpos = _floats(k.get("qpos"))[None]

        return self._assemble()

    # ---------------- tree walk ---------------------------------------
    def _parse_body_children(self, elem: ET.Element, bodyid: int, childclass: str):
        for child in elem:
            tag = child.tag
            if tag == "body":
                self._parse_body(child, bodyid, child.get("childclass", childclass))
            elif tag in ("joint", "freejoint"):
                self._parse_joint(child, bodyid, childclass)
            elif tag == "geom":
                self._parse_geom(child, bodyid, childclass)
            elif tag == "site":
                self._parse_site(child, bodyid, childclass)
            elif tag == "inertial":
                self.bodies[bodyid]["inertial"] = self._parse_inertial(child)
            # cameras / lights ignored (render-only)

    def _frame(self, a: Dict[str, str]):
        pos = _floats(a.get("pos", "0 0 0"))
        if "quat" in a:
            quat = hq.normalize(_floats(a["quat"]))
        elif "euler" in a:
            e = _floats(a["euler"])
            if self.angle == "degree":
                e = np.deg2rad(e)
            quat = _euler_to_quat_xyz_extrinsic(e)
        elif "axisangle" in a:
            v = _floats(a["axisangle"])
            ang = np.deg2rad(v[3]) if self.angle == "degree" else v[3]
            quat = hq.from_axis_angle(v[:3], np.asarray(ang))
        else:
            quat = np.array([1.0, 0, 0, 0])
        return pos, quat

    def _parse_body(self, elem: ET.Element, parentid: int, childclass: str):
        a = elem.attrib
        pos, quat = self._frame(a)
        bid = len(self.bodies)
        self.bodies.append(dict(
            name=a.get("name", f"body{bid}"), parentid=parentid, pos=pos,
            quat=quat, cls=childclass, inertial=None, jntadr=[], geomadr=[],
        ))
        self._parse_body_children(elem, bid, childclass)

    def _parse_inertial(self, elem: ET.Element):
        a = elem.attrib
        pos = _floats(a.get("pos", "0 0 0"))
        if "quat" in a:
            quat = hq.normalize(_floats(a["quat"]))
        else:
            quat = np.array([1.0, 0, 0, 0])
        mass = float(a["mass"])
        if "diaginertia" in a:
            diag = _floats(a["diaginertia"])
        else:
            fi = _floats(a["fullinertia"])  # xx yy zz xy xz yz
            I = np.array([[fi[0], fi[3], fi[4]],
                          [fi[3], fi[1], fi[5]],
                          [fi[4], fi[5], fi[2]]])
            w, v = np.linalg.eigh(I)
            order = np.argsort(w)[::-1]
            diag = w[order]
            R = v[:, order]
            if np.linalg.det(R) < 0:
                R[:, 2] *= -1
            quat = hq.mul(quat, hq.from_mat(R))
        return dict(pos=pos, quat=quat, mass=mass, diaginertia=diag)

    def _parse_joint(self, elem: ET.Element, bodyid: int, childclass: str):
        if elem.tag == "freejoint":
            a = dict(elem.attrib)
            a["type"] = "free"
        else:
            a = self.defaults.resolve("joint", elem.attrib, elem.get("class", childclass))
        jtype = {"free": FREE, "hinge": HINGE, "slide": 2, "ball": 1}[a.get("type", "hinge")]
        rng = _floats(a.get("range", "0 0"))
        if self.angle == "degree" and jtype == HINGE:
            rng = np.deg2rad(rng)
        limited = a.get("limited", "auto")
        if jtype == FREE:
            is_limited = False
        elif limited == "auto":
            is_limited = "range" in a and np.any(rng != 0)
        else:
            is_limited = limited.lower() == "true"
        self.bodies[bodyid]["jntadr"].append(len(self.joints))
        self.joints.append(dict(
            name=a.get("name", f"joint{len(self.joints)}"),
            type=jtype, bodyid=bodyid,
            pos=_floats(a.get("pos", "0 0 0")),
            axis=_floats(a.get("axis", "0 0 1")),
            range=rng, limited=is_limited,
            armature=float(a.get("armature", 0.0)),
            damping=float(a.get("damping", 0.0)),
            frictionloss=float(a.get("frictionloss", 0.0)),
            stiffness=float(a.get("stiffness", 0.0)),
            springref=float(a.get("springref", 0.0)),
        ))

    def _parse_geom(self, elem: ET.Element, bodyid: int, childclass: str):
        a = self.defaults.resolve("geom", elem.attrib, elem.get("class", childclass))
        gtype = GEOM_TYPE_NAMES[a.get("type", "sphere")]
        size = np.zeros(3)
        sz = _floats(a.get("size", "0 0 0"))
        size[: len(sz)] = sz
        pos, quat = self._frame(a)

        if "fromto" in a:
            ft = _floats(a["fromto"])
            p1, p2 = ft[:3], ft[3:]
            pos = (p1 + p2) / 2.0
            d = p2 - p1
            L = np.linalg.norm(d)
            size[1] = L / 2.0
            # rotation taking +z to d
            z = np.array([0.0, 0.0, 1.0])
            dn = d / max(L, 1e-12)
            v = np.cross(z, dn)
            s = np.linalg.norm(v)
            if s < 1e-12:
                quat = (np.array([1.0, 0, 0, 0]) if dn[2] > 0
                        else np.array([0.0, 1, 0, 0]))
            else:
                ang = float(np.arctan2(s, float(z @ dn)))
                quat = hq.from_axis_angle(v / s, np.asarray(ang))

        meshid = -1
        if gtype == MESH:
            mesh_name = a["mesh"]
            meshid = self._load_mesh(mesh_name)
            centroid, mquat = self.mesh_frames[mesh_name]
            # fold mesh principal frame into the geom frame
            pos = pos + hq.rotate(quat, centroid)
            quat = hq.mul(quat, mquat)
            size = self.mesh_aabb[mesh_name].copy()

        self.bodies[bodyid]["geomadr"].append(len(self.geoms))
        self.geoms.append(dict(
            name=a.get("name", f"geom{len(self.geoms)}"),
            type=gtype, bodyid=bodyid, pos=pos, quat=quat, size=size,
            friction=_floats(a.get("friction", "1 0.005 0.0001")),
            condim=int(a.get("condim", 3)),
            contype=int(a.get("contype", 1)),
            conaffinity=int(a.get("conaffinity", 1)),
            margin=float(a.get("margin", 0.0)),
            solref=np.array(_DEFAULT_SOLREF),
            solimp=np.array(_DEFAULT_SOLIMP),
            mass=float(a["mass"]) if "mass" in a else None,
            density=float(a.get("density", 1000.0)),
            group=int(a.get("group", 0)),
            meshid=meshid,
        ))

    def _load_mesh(self, name: str) -> int:
        if name in self.mesh_ids:
            return self.mesh_ids[name]
        tris = mesh_utils.load_stl(self.mesh_files[name])
        centroid, mquat = mesh_utils.principal_frame(tris)
        # re-express vertices in the principal frame
        allv = hq.rotate_inv(
            np.broadcast_to(mquat, (tris.reshape(-1, 3).shape[0], 4)),
            tris.reshape(-1, 3) - centroid)
        self.mesh_aabb[name] = np.abs(allv).max(0)
        hv = mesh_utils.hull_vertices(tris)
        hv = hq.rotate_inv(np.broadcast_to(mquat, (len(hv), 4)), hv - centroid)
        cpos, cquat, crad, chalf = mesh_utils.fit_capsule(hv)
        subs = tuple((p, q, r, h)
                     for p, q, r, h in mesh_utils.fit_capsules_adaptive(hv, 2))
        mid = len(self.meshes)
        self.meshes.append(Mesh(
            name=name, verts=hv, capsule_pos=cpos, capsule_quat=cquat,
            capsule_size=(crad, chalf), sub_capsules=subs,
        ))
        self.mesh_frames[name] = (centroid, mquat)
        self.mesh_ids[name] = mid
        return mid

    def _parse_site(self, elem: ET.Element, bodyid: int, childclass: str):
        a = self.defaults.resolve("site", elem.attrib, elem.get("class", childclass))
        pos, quat = self._frame(a)
        self.sites.append(dict(
            name=a.get("name", f"site{len(self.sites)}"),
            bodyid=bodyid, pos=pos, quat=quat,
        ))

    # ---------------- inertia from geoms ------------------------------
    @staticmethod
    def _geom_inertia(g: dict):
        """(mass, com(3) in body frame, inertia(3,3) about com in body frame)."""
        t, size = g["type"], g["size"]
        r = size[0]
        if t == SPHERE:
            vol = 4.0 / 3.0 * np.pi * r ** 3
            mass = g["mass"] if g["mass"] is not None else g["density"] * vol
            I = np.eye(3) * (0.4 * mass * r * r)
        elif t == CAPSULE:
            hl = size[1]
            vc = np.pi * r * r * (2 * hl)
            vs = 4.0 / 3.0 * np.pi * r ** 3
            vol = vc + vs
            mass = g["mass"] if g["mass"] is not None else g["density"] * vol
            mc, ms = mass * vc / vol, mass * vs / vol
            iz = mc * r * r / 2.0 + ms * 0.4 * r * r
            it = (mc * (3 * r * r + 4 * hl * hl) / 12.0
                  + ms * (0.4 * r * r + hl * hl + 0.75 * hl * r))
            I = np.diag([it, it, iz])
        elif t == CYLINDER:
            hl = size[1]
            vol = np.pi * r * r * (2 * hl)
            mass = g["mass"] if g["mass"] is not None else g["density"] * vol
            iz = mass * r * r / 2.0
            it = mass * (3 * r * r + 4 * hl * hl) / 12.0
            I = np.diag([it, it, iz])
        elif t == BOX:
            sx, sy, sz = size
            vol = 8.0 * sx * sy * sz
            mass = g["mass"] if g["mass"] is not None else g["density"] * vol
            I = np.diag([
                mass / 3.0 * (sy * sy + sz * sz),
                mass / 3.0 * (sx * sx + sz * sz),
                mass / 3.0 * (sx * sx + sy * sy),
            ])
        else:  # mesh/plane: not needed for inertia-from-geom models here
            mass = g["mass"] if g["mass"] is not None else 0.0
            I = np.eye(3) * 1e-9
        # rotate inertia into body frame, position at geom pos
        R = hq.to_mat(g["quat"])
        return mass, g["pos"].copy(), R @ I @ R.T

    def _body_inertial(self, b: dict):
        """Resolve (ipos, iquat, mass, diag inertia) for one body."""
        use_geoms = (self.inertiafromgeom == "true"
                     or (self.inertiafromgeom == "auto" and b["inertial"] is None))
        if not use_geoms and b["inertial"] is not None:
            inr = b["inertial"]
            return inr["pos"], inr["quat"], inr["mass"], inr["diaginertia"]
        parts = [self._geom_inertia(self.geoms[gi]) for gi in b["geomadr"]]
        parts = [p for p in parts if p[0] > 0]
        if not parts:
            return np.zeros(3), np.array([1.0, 0, 0, 0]), 0.0, np.zeros(3)
        mass = sum(p[0] for p in parts)
        com = sum(p[0] * p[1] for p in parts) / mass
        I = np.zeros((3, 3))
        for m, c, Ic in parts:
            d = c - com
            I += Ic + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
        w, v = np.linalg.eigh(I)
        order = np.argsort(w)[::-1]
        diag = w[order]
        R = v[:, order]
        if np.linalg.det(R) < 0:
            R[:, 2] *= -1
        return com, hq.from_mat(R), mass, diag

    # ---------------- assembly ----------------------------------------
    def _reorder_body_major(self):
        """Renumber joints/geoms/sites body-major (stable within a body),
        matching the engine compiler's element numbering."""
        def sort(lst):
            order = sorted(range(len(lst)), key=lambda i: lst[i]["bodyid"])
            return [lst[i] for i in order]

        self.joints = sort(self.joints)
        self.geoms = sort(self.geoms)
        self.sites = sort(self.sites)
        for i, b in enumerate(self.bodies):
            b["jntadr"] = [j for j, jd in enumerate(self.joints)
                           if jd["bodyid"] == i]
            b["geomadr"] = [g for g, gd in enumerate(self.geoms)
                            if gd["bodyid"] == i]

    def _assemble(self) -> PhysicsModel:
        self._reorder_body_major()
        nbody = len(self.bodies)
        njnt = len(self.joints)
        ngeom = len(self.geoms)
        qpos_w = {FREE: 7, 1: 4, 2: 1, HINGE: 1}
        dof_w = {FREE: 6, 1: 3, 2: 1, HINGE: 1}

        jnt_qposadr = np.zeros(njnt, dtype=np.int64)
        jnt_dofadr = np.zeros(njnt, dtype=np.int64)
        nq = nv = 0
        for j, jd in enumerate(self.joints):
            jnt_qposadr[j] = nq
            jnt_dofadr[j] = nv
            nq += qpos_w[jd["type"]]
            nv += dof_w[jd["type"]]

        body_parentid = np.array([b["parentid"] if b["parentid"] >= 0 else 0
                                  for b in self.bodies], dtype=np.int64)
        body_rootid = np.zeros(nbody, dtype=np.int64)
        for i in range(1, nbody):
            p = body_parentid[i]
            body_rootid[i] = i if p == 0 else body_rootid[p]

        body_jntnum = np.array([len(b["jntadr"]) for b in self.bodies], dtype=np.int64)
        body_jntadr = np.array([b["jntadr"][0] if b["jntadr"] else -1
                                for b in self.bodies], dtype=np.int64)
        body_dofnum = np.array(
            [sum(dof_w[self.joints[j]["type"]] for j in b["jntadr"])
             for b in self.bodies], dtype=np.int64)
        body_dofadr = np.array(
            [jnt_dofadr[b["jntadr"][0]] if b["jntadr"] else -1
             for b in self.bodies], dtype=np.int64)
        body_weldid = np.zeros(nbody, dtype=np.int64)
        for i in range(1, nbody):
            body_weldid[i] = i if body_jntnum[i] > 0 else body_weldid[body_parentid[i]]

        # dofs
        dof_bodyid = np.zeros(nv, dtype=np.int64)
        dof_jntid = np.zeros(nv, dtype=np.int64)
        dof_armature = np.zeros(nv)
        dof_damping = np.zeros(nv)
        dof_frictionloss = np.zeros(nv)
        for j, jd in enumerate(self.joints):
            w = dof_w[jd["type"]]
            sl = slice(jnt_dofadr[j], jnt_dofadr[j] + w)
            dof_bodyid[sl] = jd["bodyid"]
            dof_jntid[sl] = j
            dof_armature[sl] = jd["armature"]
            dof_damping[sl] = jd["damping"]
            dof_frictionloss[sl] = jd["frictionloss"]

        # dof_parentid: previous dof within joint, else last dof of
        # nearest ancestor body with dofs
        last_dof_of_body = {}
        for i in range(nbody):
            if body_dofnum[i] > 0:
                last_dof_of_body[i] = int(body_dofadr[i] + body_dofnum[i] - 1)
        dof_parentid = np.full(nv, -1, dtype=np.int64)
        for j, jd in enumerate(self.joints):
            w = dof_w[jd["type"]]
            adr = int(jnt_dofadr[j])
            # ancestor body with dofs
            p = body_parentid[jd["bodyid"]]
            anc = -1
            while p > 0:
                if body_dofnum[p] > 0:
                    anc = last_dof_of_body[int(p)]
                    break
                p = body_parentid[p]
            # joints listed earlier on the same body chain before this one
            first = adr
            for k in range(w):
                dof_parentid[adr + k] = adr + k - 1 if adr + k > first else anc
            # if multiple joints on one body, MJCF order chains them
            jprev = [jj for jj in self.bodies[jd["bodyid"]]["jntadr"] if jj < j]
            if jprev:
                prev = max(jprev)
                dof_parentid[adr] = int(jnt_dofadr[prev] + dof_w[self.joints[prev]["type"]] - 1)

        # inertials
        body_ipos = np.zeros((nbody, 3))
        body_iquat = np.tile(np.array([1.0, 0, 0, 0]), (nbody, 1))
        body_mass = np.zeros(nbody)
        body_inertia = np.zeros((nbody, 3))
        for i, b in enumerate(self.bodies):
            if i == 0:
                continue
            ipos, iquat, mass, diag = self._body_inertial(b)
            body_ipos[i], body_iquat[i] = ipos, iquat
            body_mass[i], body_inertia[i] = mass, diag

        # collision pairs
        name2bid = {b["name"]: i for i, b in enumerate(self.bodies)}
        excl = set()
        for b1, b2 in self.excludes:
            i1, i2 = name2bid[b1], name2bid[b2]
            excl.add((min(i1, i2), max(i1, i2)))
        pair1, pair2 = [], []
        for g1 in range(ngeom):
            for g2 in range(g1 + 1, ngeom):
                a, b = self.geoms[g1], self.geoms[g2]
                if not ((a["contype"] & b["conaffinity"])
                        or (b["contype"] & a["conaffinity"])):
                    continue
                b1, b2 = a["bodyid"], b["bodyid"]
                if b1 == b2:
                    continue
                w1, w2 = body_weldid[b1], body_weldid[b2]
                if w1 == w2:
                    continue
                # parent filter (weld-aware, world exempt)
                pw1 = body_weldid[body_parentid[w1]]
                pw2 = body_weldid[body_parentid[w2]]
                if (w1 != 0 and w2 != 0) and (pw1 == w2 or pw2 == w1):
                    continue
                if (min(b1, b2), max(b1, b2)) in excl:
                    continue
                if a["type"] == PLANE and b["type"] == PLANE:
                    continue
                pair1.append(g1)
                pair2.append(g2)

        jname2id = {jd["name"]: j for j, jd in enumerate(self.joints)}
        site_names = tuple(s["name"] for s in self.sites)
        sname2id = {n: i for i, n in enumerate(site_names)}

        return PhysicsModel(
            nq=nq, nv=nv, nu=len(self.actuators), nbody=nbody, njnt=njnt,
            ngeom=ngeom, nsite=len(self.sites), nconmax=self.nconmax,
            opt=self.opt,
            body_parentid=body_parentid, body_rootid=body_rootid,
            body_weldid=body_weldid,
            body_jntnum=body_jntnum, body_jntadr=body_jntadr,
            body_dofnum=body_dofnum, body_dofadr=body_dofadr,
            body_pos=np.stack([b["pos"] for b in self.bodies]),
            body_quat=np.stack([b["quat"] for b in self.bodies]),
            body_ipos=body_ipos, body_iquat=body_iquat,
            body_mass=body_mass, body_inertia=body_inertia,
            jnt_type=np.array([j["type"] for j in self.joints], dtype=np.int64),
            jnt_bodyid=np.array([j["bodyid"] for j in self.joints], dtype=np.int64),
            jnt_qposadr=jnt_qposadr, jnt_dofadr=jnt_dofadr,
            jnt_axis=np.stack([j["axis"] for j in self.joints]),
            jnt_pos=np.stack([j["pos"] for j in self.joints]),
            jnt_range=np.stack([j["range"] for j in self.joints]),
            jnt_limited=np.array([j["limited"] for j in self.joints], dtype=bool),
            jnt_stiffness=np.array([j["stiffness"] for j in self.joints]),
            jnt_springref=np.array([j["springref"] for j in self.joints]),
            dof_bodyid=dof_bodyid, dof_jntid=dof_jntid,
            dof_parentid=dof_parentid,
            dof_armature=dof_armature, dof_damping=dof_damping,
            dof_frictionloss=dof_frictionloss,
            geom_type=np.array([g["type"] for g in self.geoms], dtype=np.int64),
            geom_bodyid=np.array([g["bodyid"] for g in self.geoms], dtype=np.int64),
            geom_pos=np.stack([g["pos"] for g in self.geoms]),
            geom_quat=np.stack([g["quat"] for g in self.geoms]),
            geom_size=np.stack([g["size"] for g in self.geoms]),
            geom_friction=np.stack([g["friction"] for g in self.geoms]),
            geom_condim=np.array([g["condim"] for g in self.geoms], dtype=np.int64),
            geom_contype=np.array([g["contype"] for g in self.geoms], dtype=np.int64),
            geom_conaffinity=np.array([g["conaffinity"] for g in self.geoms], dtype=np.int64),
            geom_margin=np.array([g["margin"] for g in self.geoms]),
            geom_solref=np.stack([g["solref"] for g in self.geoms]),
            geom_solimp=np.stack([g["solimp"] for g in self.geoms]),
            geom_meshid=np.array([g["meshid"] for g in self.geoms], dtype=np.int64),
            site_bodyid=np.array([s["bodyid"] for s in self.sites], dtype=np.int64)
            if self.sites else np.zeros(0, dtype=np.int64),
            site_pos=np.stack([s["pos"] for s in self.sites]) if self.sites
            else np.zeros((0, 3)),
            site_quat=np.stack([s["quat"] for s in self.sites]) if self.sites
            else np.zeros((0, 4)),
            actuator_trnid=np.array([jname2id[a["joint"]] for a in self.actuators],
                                    dtype=np.int64),
            actuator_gear=np.array([a["gear"] for a in self.actuators]),
            actuator_ctrlrange=np.stack([a["ctrlrange"] for a in self.actuators])
            if self.actuators else np.zeros((0, 2)),
            actuator_ctrllimited=np.array([a["ctrllimited"] for a in self.actuators],
                                          dtype=bool),
            body_names=tuple(b["name"] for b in self.bodies),
            joint_names=tuple(j["name"] for j in self.joints),
            geom_names=tuple(g["name"] for g in self.geoms),
            site_names=site_names,
            actuator_names=tuple(a["name"] for a in self.actuators),
            pair_geom1=np.array(pair1, dtype=np.int64),
            pair_geom2=np.array(pair2, dtype=np.int64),
            exclude_body_pairs=tuple(sorted(excl)),
            meshes=tuple(self.meshes),
            key_qpos=self.key_qpos,
            sensor_types=tuple(s[0] for s in self.sensors),
            sensor_siteid=tuple(sname2id.get(s[1], -1) for s in self.sensors),
        )


def load_model(path: str) -> PhysicsModel:
    """Parse an MJCF file into a :class:`PhysicsModel`."""
    return _Builder(path).parse()
