"""Immutable physics model: the compile-time description of a robot.

The model is produced once on host by the MJCF parser
(:mod:`deepmimic_mujoco_tpu_torch.models.mjcf`). The torch physics reads
its arrays as constants: tree structure, joint addressing and collision
pairing are static, and every tensor shape follows from the model.

Field semantics mirror the reference engine's model fields that the
reference repo consumes (reference: src/deepmimic_env.py:196-247 uses
body_mass / jnt_range / geom_name2id / body_name2id /
get_joint_qpos_addr / joint_names), so env code ports 1:1.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

# Joint types (MuJoCo enum values for familiarity)
FREE, BALL, SLIDE, HINGE = 0, 1, 2, 3
# Geom types
PLANE, HFIELD, SPHERE, CAPSULE, ELLIPSOID, CYLINDER, BOX, MESH = range(8)

GEOM_TYPE_NAMES = {
    "plane": PLANE, "sphere": SPHERE, "capsule": CAPSULE,
    "ellipsoid": ELLIPSOID, "cylinder": CYLINDER, "box": BOX, "mesh": MESH,
}

# Integrators
EULER, RK4 = 0, 1


@dataclasses.dataclass(frozen=True)
class Option:
    timestep: float = 0.002
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    integrator: int = EULER
    iterations: int = 50
    density: float = 0.0      # medium density (unused by these models)
    viscosity: float = 0.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Reduced collision representation of a triangle mesh.

    ``verts`` are convex-hull vertices (body-geom frame, subsampled to a
    bounded count) used for exact-ish plane contacts; ``capsule`` is a
    PCA-fitted proxy (pos, quat, radius, half_length) used for
    mesh-vs-primitive and mesh-vs-mesh contacts.
    """
    name: str
    verts: np.ndarray                     # (K, 3)
    capsule_pos: np.ndarray               # (3,)
    capsule_quat: np.ndarray              # (4,) wxyz, z = axis
    capsule_size: Tuple[float, float]     # (radius, half_length)
    # finer 2-segment decomposition along the principal axis, used by
    # Engine(mesh_subcapsules=2) for tighter self-collision in collapse
    # poses; each entry is (pos, quat_wxyz, radius, half_length)
    sub_capsules: tuple = ()


@dataclasses.dataclass
class PhysicsModel:
    """Host-side immutable model. All arrays are numpy (float64/int64)."""

    # ---- sizes -------------------------------------------------------
    nq: int
    nv: int
    nu: int
    nbody: int
    njnt: int
    ngeom: int
    nsite: int
    nconmax: int                # from <size nconmax=...> (informational)

    opt: Option

    # ---- bodies ------------------------------------------------------
    body_parentid: np.ndarray   # (nbody,) int
    body_rootid: np.ndarray     # (nbody,) int: top non-world ancestor
    body_weldid: np.ndarray     # (nbody,) int: nearest ancestor w/ a joint (incl self)
    body_jntnum: np.ndarray     # (nbody,) int
    body_jntadr: np.ndarray     # (nbody,) int (-1 if none)
    body_dofnum: np.ndarray     # (nbody,) int
    body_dofadr: np.ndarray     # (nbody,) int (-1 if none)
    body_pos: np.ndarray        # (nbody, 3) frame offset in parent
    body_quat: np.ndarray       # (nbody, 4) wxyz
    body_ipos: np.ndarray       # (nbody, 3) inertial frame pos in body
    body_iquat: np.ndarray      # (nbody, 4)
    body_mass: np.ndarray       # (nbody,)
    body_inertia: np.ndarray    # (nbody, 3) principal moments

    # ---- joints ------------------------------------------------------
    jnt_type: np.ndarray        # (njnt,) int
    jnt_bodyid: np.ndarray      # (njnt,) int
    jnt_qposadr: np.ndarray     # (njnt,) int
    jnt_dofadr: np.ndarray      # (njnt,) int
    jnt_axis: np.ndarray        # (njnt, 3)
    jnt_pos: np.ndarray         # (njnt, 3) anchor in body frame
    jnt_range: np.ndarray       # (njnt, 2)
    jnt_limited: np.ndarray     # (njnt,) bool
    jnt_stiffness: np.ndarray   # (njnt,)
    jnt_springref: np.ndarray   # (njnt,)

    # ---- dofs --------------------------------------------------------
    dof_bodyid: np.ndarray      # (nv,) int
    dof_jntid: np.ndarray       # (nv,) int
    dof_parentid: np.ndarray    # (nv,) int: parent dof in tree (-1 root)
    dof_armature: np.ndarray    # (nv,)
    dof_damping: np.ndarray     # (nv,)
    dof_frictionloss: np.ndarray  # (nv,)

    # ---- geoms -------------------------------------------------------
    geom_type: np.ndarray       # (ngeom,) int
    geom_bodyid: np.ndarray     # (ngeom,) int
    geom_pos: np.ndarray        # (ngeom, 3)
    geom_quat: np.ndarray       # (ngeom, 4)
    geom_size: np.ndarray       # (ngeom, 3)
    geom_friction: np.ndarray   # (ngeom, 3) slide, torsion, roll
    geom_condim: np.ndarray     # (ngeom,) int
    geom_contype: np.ndarray    # (ngeom,) int
    geom_conaffinity: np.ndarray  # (ngeom,) int
    geom_margin: np.ndarray     # (ngeom,)
    geom_solref: np.ndarray     # (ngeom, 2)
    geom_solimp: np.ndarray     # (ngeom, 5)
    geom_meshid: np.ndarray     # (ngeom,) int (-1 if not mesh)

    # ---- sites (for sensors) ----------------------------------------
    site_bodyid: np.ndarray     # (nsite,) int
    site_pos: np.ndarray        # (nsite, 3)
    site_quat: np.ndarray       # (nsite, 4)

    # ---- actuators ---------------------------------------------------
    actuator_trnid: np.ndarray      # (nu,) joint id
    actuator_gear: np.ndarray       # (nu,)
    actuator_ctrlrange: np.ndarray  # (nu, 2)
    actuator_ctrllimited: np.ndarray  # (nu,) bool

    # ---- names -------------------------------------------------------
    body_names: Tuple[str, ...]
    joint_names: Tuple[str, ...]
    geom_names: Tuple[str, ...]
    site_names: Tuple[str, ...]
    actuator_names: Tuple[str, ...]

    # ---- collision pre-pairing --------------------------------------
    # Candidate geom pairs that pass contype/conaffinity, same-body,
    # parent-filter and <exclude> rules; computed once at build time.
    pair_geom1: np.ndarray      # (npair,) int
    pair_geom2: np.ndarray      # (npair,) int

    # excluded body pairs (from <contact><exclude>)
    exclude_body_pairs: Tuple[Tuple[int, int], ...]

    # ---- meshes ------------------------------------------------------
    meshes: Tuple[Mesh, ...]

    # ---- keyframes ---------------------------------------------------
    key_qpos: Optional[np.ndarray]  # (nkey, nq) or None

    # ---- sensors -----------------------------------------------------
    sensor_types: Tuple[str, ...]
    sensor_siteid: Tuple[int, ...]

    # lookup caches
    _body_name2id: Dict[str, int] = dataclasses.field(default_factory=dict)
    _geom_name2id: Dict[str, int] = dataclasses.field(default_factory=dict)
    _joint_name2id: Dict[str, int] = dataclasses.field(default_factory=dict)
    _site_name2id: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self._body_name2id = {n: i for i, n in enumerate(self.body_names)}
        self._geom_name2id = {n: i for i, n in enumerate(self.geom_names)}
        self._joint_name2id = {n: i for i, n in enumerate(self.joint_names)}
        self._site_name2id = {n: i for i, n in enumerate(self.site_names)}

    # -- reference-compatible lookups (src/deepmimic_env.py:50,231) ----
    def body_name2id(self, name: str) -> int:
        return self._body_name2id[name]

    def geom_name2id(self, name: str) -> int:
        return self._geom_name2id[name]

    def geom_id2name(self, gid: int) -> str:
        return self.geom_names[gid]

    def joint_name2id(self, name: str) -> int:
        return self._joint_name2id[name]

    def site_name2id(self, name: str) -> int:
        return self._site_name2id[name]

    def get_joint_qpos_addr(self, name: str):
        """Reference semantics: int for hinge, (start, end) for free."""
        j = self._joint_name2id[name]
        adr = int(self.jnt_qposadr[j])
        if self.jnt_type[j] == FREE:
            return (adr, adr + 7)
        if self.jnt_type[j] == BALL:
            return (adr, adr + 4)
        return adr

    @property
    def jnt_qpos_width(self):
        return {FREE: 7, BALL: 4, SLIDE: 1, HINGE: 1}

    @property
    def jnt_dof_width(self):
        return {FREE: 6, BALL: 3, SLIDE: 1, HINGE: 1}
