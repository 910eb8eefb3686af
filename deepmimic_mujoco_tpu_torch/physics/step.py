"""Engine: the forward-dynamics pipeline and its integrators.

One ``Engine`` per :class:`PhysicsModel` precomputes all static tables
(collision pair slots, dof masks, limit rows) at build time; its
``forward``/``step`` methods are batch-major torch functions of
(qpos (B, nq), qvel (B, nv), ctrl (B, nu)).

Pipeline: kinematics -> com quantities -> collision -> velocities ->
CRBA -> RNE bias -> passive + actuation -> fused mass-matrix and
contact/limit constraint solve -> integrate (semi-implicit Euler with
implicit joint damping, or RK4, the reference MJCF's integrator).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from deepmimic_mujoco_tpu_torch.models.physics_model import (
    FREE, HINGE, RK4, PhysicsModel,
)
from deepmimic_mujoco_tpu_torch.ops import fused_solve
from deepmimic_mujoco_tpu_torch.physics import dynamics
from deepmimic_mujoco_tpu_torch.physics.collision import (
    Contacts, build_pair_tables, calibrate_proxy_gaps, collide, total_slots,
)
from deepmimic_mujoco_tpu_torch.physics.kinematics import (
    Com, Kin, com_pos, com_vel, fwd_kinematics,
)
from deepmimic_mujoco_tpu_torch.physics.solver import solve_constraints
from deepmimic_mujoco_tpu_torch.utils import quat as tq
from deepmimic_mujoco_tpu_torch.utils import tracing
from deepmimic_mujoco_tpu_torch.utils.device import (
    const, fp32_physics, resolve_device,
)


class EngineData(NamedTuple):
    """Everything an env layer reads after a forward pass, batch-major."""
    kin: Kin
    com: Com
    cvel: torch.Tensor             # (B, nbody, 6)
    contacts: Contacts
    qacc: torch.Tensor             # (B, nv)
    qfrc_smooth: torch.Tensor      # (B, nv)
    qfrc_constraint: torch.Tensor  # (B, nv)
    lam: torch.Tensor              # (B, n_warm_rows) warm-start carry


def _neutral_qpos(model: PhysicsModel) -> np.ndarray:
    q = np.zeros(model.nq)
    if model.njnt and model.jnt_type[0] == FREE:
        q[2] = 10.0  # high above the floor
        q[3] = 1.0
    return q


class Engine:
    def __init__(self, model: PhysicsModel, max_contacts: int = 24,
                 iterations: Optional[int] = None,
                 integrator: Optional[int] = None,
                 warm_start_lam: bool = True,
                 mesh_subcapsules: int = 2,
                 cone: str = "elliptic",
                 device="cuda"):
        self.device = resolve_device(device)
        fp32_physics()
        self.m = model
        self.max_contacts = max_contacts
        self.iterations = iterations if iterations is not None \
            else model.opt.iterations
        self.integrator = integrator if integrator is not None \
            else model.opt.integrator
        self.single_free_root = bool(
            model.njnt and model.jnt_type[0] == FREE
            and np.all(np.asarray(model.jnt_type[1:]) == HINGE))
        self.dt = model.opt.timestep
        with tracing.setup("setup.tables"):
            self.tables = build_pair_tables(model, mesh_subcapsules)
            if any(g.is_proxy.any() for g in self.tables):
                calib = (model.key_qpos[0] if model.key_qpos is not None
                         else _neutral_qpos(model))
                self.tables = calibrate_proxy_gaps(model, self.tables, calib)
            self.body_dof = dynamics.body_dof_mask(model)
            self.limit_table = dynamics.limited_hinge_table(model)
        self.n_constraint_rows = (3 * self.max_contacts
                                  + len(self.limit_table[0]))
        # Warm-start forces are carried PAIR-KEYED, not slot-keyed: top-K
        # compaction orders contact slots by depth, so a slot's identity
        # churns whenever relative depths reorder. The carry is the
        # compact force vector plus each slot's static pair-slot id; the
        # next step matches ids (a K x K one-hot) so a persisting contact
        # keeps its force no matter how the compaction reorders.
        self.n_pair_slots = total_slots(self.tables)
        self.k_slots = min(self.max_contacts, self.n_pair_slots)
        self.n_warm_rows = (3 * self.k_slots + len(self.limit_table[0])
                            + self.k_slots)
        # the kernel's launch plan on the card, made once here (the
        # wrapper's launch_plan caches it); it raises, naming the largest
        # max_contacts that fits, when the kernel holds no such env
        self.solve_plan = (fused_solve.check_fits(
            model.nv, self.k_slots, len(self.limit_table[0]))
            if self.device.type == "cuda" else None)
        # Warm-starting from the previous step's forces shifts the
        # 50-iteration partial solution; the committed gate policies
        # are trained against it.
        self.warm_start_lam = warm_start_lam
        self.cone = cone

    # ---- stages -------------------------------------------------------
    def position_stage(self, qpos):
        with tracing.span("engine.kinematics"):
            kin = fwd_kinematics(self.m, qpos)
            com = com_pos(self.m, kin)
        with tracing.span("engine.collision"):
            contacts = collide(self.m, self.tables, kin, self.max_contacts)
        return kin, com, contacts

    def forward(self, qpos, qvel, ctrl, h_implicit: float = 0.0,
                lam0=None) -> EngineData:
        """Full dynamics: qacc under current state + control.

        ``h_implicit > 0`` is the Euler integrator's implicit joint
        damping: the mass matrix is augmented with ``h*diag(damping +
        c_fric)`` and joint frictionloss is a linearized implicit
        Coulomb force (exactly +-floss for |v| > 5e-3, linear near zero,
        unconditionally stable even on near-massless dofs). The default
        ``h_implicit = 0`` is the explicit path: M̂ = M and frictionloss
        ``-floss*tanh(qvel/0.05)``. The damping force itself is always
        applied explicitly. ``lam0`` (B, n_warm_rows) warm-starts the
        constraint solve in PAIR-SLOT space; it is gathered onto this
        step's compacted slots.
        """
        m = self.m
        kin, com, contacts = self.position_stage(qpos)
        if lam0 is not None:
            lam0 = self._gather_warm(contacts.slot_idx, lam0)
        with tracing.span("engine.dynamics"):
            cvel, cdof_dot = com_vel(m, com, qvel)

            M = dynamics.crb(m, com)
            bias = dynamics.rne(m, com, cvel, cdof_dot, qvel)
            dev, dt = qvel.device, qvel.dtype
            damping = const(m, "dof_damping", lambda: m.dof_damping, dev, dt)
            floss = const(m, "dof_frictionloss", lambda: m.dof_frictionloss,
                          dev, dt)
            if h_implicit:
                c_fric = floss / torch.clamp(torch.abs(qvel), min=5e-3)
                fric_force = -c_fric * qvel
            else:
                fric_force = -floss * torch.tanh(qvel / 0.05)

            passive = (dynamics.passive_force(m, qpos, qvel)
                       - damping * qvel + fric_force)
            act = dynamics.actuator_force(m, ctrl)
            qfrc_smooth = passive + act - bias

            M_hat = (M + h_implicit * torch.diag_embed(damping + c_fric)
                     if h_implicit else M)

        with tracing.span("engine.constraints"):
            res = solve_constraints(
                m, com, M_hat, qfrc_smooth, qpos, qvel, contacts,
                self.body_dof, self.limit_table, iterations=self.iterations,
                lam0=lam0, cone=self.cone)
            lam = self._scatter_warm(contacts.slot_idx, res.lam)

        return EngineData(kin=kin, com=com, cvel=cvel, contacts=contacts,
                          qacc=res.qacc, qfrc_smooth=qfrc_smooth,
                          qfrc_constraint=res.qfrc_constraint, lam=lam)

    # ---- pair-keyed warm start ------------------------------------------
    # Carried layout: [normal(K), t1(K), t2(K), limits(L), slot_idx(K) as
    # float]; the solver's compact lam is [normal(K), t1(K), t2(K),
    # limits(L)] over this step's top-K slots. Gathering = matching
    # previous ids to current ids (ids are unique, and any pair absent
    # from the previous top-K carried zero force by construction).
    def _gather_warm(self, slot_idx, lam_packed):
        K = slot_idx.shape[1]
        nl = 3 * K + len(self.limit_table[0])
        lamp = lam_packed[:, :nl]
        idx_prev = lam_packed[:, nl:].to(torch.int64)
        match = (slot_idx[:, :, None] == idx_prev[:, None, :]).to(
            lam_packed.dtype)                                # (B, K, K)
        parts = [(match @ lamp[:, i * K:(i + 1) * K, None])[..., 0]
                 for i in range(3)]
        return torch.cat(parts + [lamp[:, 3 * K:]], 1)

    def _scatter_warm(self, slot_idx, lam):
        return torch.cat([lam, slot_idx.to(lam.dtype)], 1)

    def empty_lam(self, batch: int, dtype=torch.float32):
        """Zero warm-start carry (B, n_warm_rows). The trailing slot-id
        segment is -1 (no real pair-slot id is negative) so an 'empty'
        entry can never alias the valid pair-slot id 0."""
        lam = torch.zeros(batch, self.n_warm_rows, dtype=dtype,
                          device=self.device)
        lam[:, self.n_warm_rows - self.k_slots:] = -1.0
        return lam

    # ---- integration ---------------------------------------------------
    def integrate_pos(self, qpos, qvel, h):
        """qpos advance with quaternion integration of free joints
        (local-frame angular velocity convention). Fast path for a free
        root followed by hinges; the per-joint loop otherwise."""
        if self.single_free_root:
            quat = tq.integrate(qpos[:, 3:7], qvel[:, 3:6], h)
            return torch.cat([qpos[:, 0:3] + h * qvel[:, 0:3], quat,
                              qpos[:, 7:] + h * qvel[:, 6:]], 1)
        return self.integrate_pos_generic(qpos, qvel, h)

    def integrate_pos_generic(self, qpos, qvel, h):
        """The per-joint loop: free joints move and turn, every other
        joint advances one scalar (the JAX package treats hinge and slide
        alike, and so does this)."""
        m = self.m
        new = qpos.clone()
        for j in range(m.njnt):
            qadr = int(m.jnt_qposadr[j])
            dadr = int(m.jnt_dofadr[j])
            if m.jnt_type[j] == FREE:
                new[:, qadr:qadr + 3] = (qpos[:, qadr:qadr + 3]
                                         + h * qvel[:, dadr:dadr + 3])
                new[:, qadr + 3:qadr + 7] = tq.integrate(
                    qpos[:, qadr + 3:qadr + 7], qvel[:, dadr + 3:dadr + 6], h)
            else:
                new[:, qadr] = qpos[:, qadr] + h * qvel[:, dadr]
        return new

    def step(self, qpos, qvel, ctrl, lam0=None):
        """One physics step at the model timestep. Returns (qpos', qvel',
        EngineData).

        Euler: semi-implicit with implicit joint damping; the data is
        the forward evaluation at the pre-step state. RK4: four explicit
        forwards at offsets (0, h/2, h/2, h), each cold-started (``lam0``
        is ignored, as in the JAX package), weighted (1, 2, 2, 1)/6; the
        data is the pre-step position/velocity view (no fifth forward),
        whose ``lam`` is the empty warm start."""
        h = self.dt
        if self.integrator == RK4:
            return self._step_rk4(qpos, qvel, ctrl)
        if not self.warm_start_lam:
            lam0 = None
        d = self.forward(qpos, qvel, ctrl, h_implicit=h, lam0=lam0)
        with tracing.span("engine.integrate"):
            qvel_new = qvel + d.qacc * h
            qpos_new = self.integrate_pos(qpos, qvel_new, h)
        return qpos_new, qvel_new, d

    def _step_rk4(self, qpos, qvel, ctrl):
        v_prev, a_prev = qvel, torch.zeros_like(qvel)
        vs, accs = [], []
        for off in (0.0, self.dt / 2, self.dt / 2, self.dt):
            with tracing.span("engine.integrate"):
                q_i = self.integrate_pos(qpos, v_prev, off)
                v_i = qvel + a_prev * off
            a_i = self.forward(q_i, v_i, ctrl).qacc
            vs.append(v_i)
            accs.append(a_i)
            v_prev, a_prev = v_i, a_i
        with tracing.span("engine.integrate"):
            w = const(self.m, "rk4_weights",
                      lambda: np.asarray([1.0, 2.0, 2.0, 1.0], np.float32),
                      qpos.device, qpos.dtype)[:, None, None] / 6.0
            v_avg = (torch.stack(vs) * w).sum(0)
            a_avg = (torch.stack(accs) * w).sum(0)
            qpos_new = self.integrate_pos(qpos, v_avg, self.dt)
            qvel_new = qvel + a_avg * self.dt
        return qpos_new, qvel_new, self.data_view(qpos, qvel)

    def data_view(self, qpos, qvel) -> EngineData:
        """Position+velocity stage fields only (no dynamics)."""
        kin, com, contacts = self.position_stage(qpos)
        cvel, _ = com_vel(self.m, com, qvel)
        z = torch.zeros_like(qvel)
        return EngineData(kin=kin, com=com, cvel=cvel, contacts=contacts,
                          qacc=z, qfrc_smooth=z, qfrc_constraint=z,
                          lam=self.empty_lam(qpos.shape[0], qpos.dtype))
