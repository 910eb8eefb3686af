"""Port parity at the Unitree G1: kinematics, dynamics, the contact set
with the plane-mesh kind, Engine.step and the fused solve's parts entry
on G1 main-path inputs, against the JAX package on the CPU; and the
exported G1 gate actors against their orbax checkpoints. DPEnv at G1 is
in tests/test_torch_g1_env.py.

Inputs are clip frames (made with numpy, float32), jittered copies
lowered into the floor, and a prone pose sunk far enough that the 24
contact slots saturate; at 128 slots (the card's shared-memory plan)
none is dropped. Float32 agreement of FK/com/CRBA/RNE and of
contact distances is held to 1e-5 relative to each quantity's scale;
the contact sets (slot layout, ``slot_idx``, geoms, condim, overflow)
must be identical, up to the order of slots whose depths lie within
1e-6 m of each other, where float32 rounding alone decides (see
``assert_same_contact_set``). Steps go through the solve (the JAX
package's XLA fallback against the port's Cholesky-based plain
version), so states after a step are held to 5e-3, the end-to-end
tolerance of tests/test_fused_solve.py.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.mocap import load_clip as jload_clip
from deepmimic_mujoco_tpu.models import assets as jassets
from deepmimic_mujoco_tpu.models import load_model as jload_model
from deepmimic_mujoco_tpu.models.physics_model import EULER
from deepmimic_mujoco_tpu.ops.fused_solve import fused_solve_parts_single
from deepmimic_mujoco_tpu.physics import collision as jcol
from deepmimic_mujoco_tpu.physics import dynamics as jdyn
from deepmimic_mujoco_tpu.physics import kinematics as jkin
from deepmimic_mujoco_tpu.physics.step import Engine as JEngine

from deepmimic_mujoco_tpu_torch.models import load_model
from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs
from deepmimic_mujoco_tpu_torch.physics import collision as tcol
from deepmimic_mujoco_tpu_torch.physics import dynamics as tdyn
from deepmimic_mujoco_tpu_torch.physics import kinematics as tkin
from deepmimic_mujoco_tpu_torch.physics import solver as tsolver
from deepmimic_mujoco_tpu_torch.physics.step import Engine

TOL = 1e-5
TOL_STEP = 5e-3
TOL_KERNEL = 2e-4
K = 24
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACTORS = {
    "walk": "runs/walk_test20260817-1741_21_videos/"
            "walk_test20260817-1741_21_best",
    "run": "runs/run_r5_default_gate",
    "getup": "runs/getup_facedown_slow_FSI_test20260819-1856_58_videos/"
             "getup_facedown_slow_FSI_test20260819-1856_58_best",
}


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1.0)


@pytest.fixture(scope="module")
def setup():
    path = jassets.xml_path("unitree_g1")
    jm, tm = jload_model(path), load_model(path)
    je = JEngine(jm, max_contacts=K, integrator=EULER)
    te = Engine(tm, max_contacts=K, integrator=EULER, device="cpu")
    walk = jload_clip(jassets.mocap_path("unitree_g1", "walk"), jm)
    getup = jload_clip(jassets.mocap_path("unitree_g1",
                                          "getup_facedown_slow_FSI"), jm)
    r = np.random.RandomState(0)
    q = walk.qpos[np.arange(0, len(walk), len(walk) // 4)[:4]]
    qp = q.copy()
    qp[:, 7:] += r.uniform(-0.1, 0.1, qp[:, 7:].shape)
    qp[:, 2] -= r.uniform(0.0, 0.04, len(qp))
    prone = getup.qpos[:1].copy()
    prone[:, 2] -= 0.06            # sunk: more active contacts than slots
    qpos = np.concatenate([q, qp, prone]).astype(np.float32)
    qvel = np.concatenate([walk.qvel[:len(q)], walk.qvel[:len(q)],
                           getup.qvel[:1]]).astype(np.float32)
    ctrl = (r.uniform(-1, 1, (len(qpos), jm.nu)) * 20).astype(np.float32)
    return jm, tm, je, te, qpos, qvel, ctrl


@pytest.fixture(scope="module")
def jax_step(setup):
    """The JAX engine's batched step, compiled once for both step counts."""
    return jax.jit(jax.vmap(setup[2].step))


def test_g1_kinematics_and_dynamics_match(setup):
    jm, tm, _, _, qpos, qvel, _ = setup

    def one(q, v):
        kin = jkin.fwd_kinematics(jm, q)
        com = jkin.com_pos(jm, kin)
        cvel, cdof_dot = jkin.com_vel(jm, com, v)
        return kin, com, dict(
            cvel=cvel, mass_center=jkin.mass_center(jm, kin),
            M=jdyn.crb(jm, com), bias=jdyn.rne(jm, com, cvel, cdof_dot, v))

    with jax.default_matmul_precision("highest"):
        jkin_, jcom, jrest = jax.jit(jax.vmap(one))(jnp.asarray(qpos),
                                                     jnp.asarray(qvel))
    q, v = torch.tensor(qpos), torch.tensor(qvel)
    kin = tkin.fwd_kinematics(tm, q)
    com = tkin.com_pos(tm, kin)
    cvel, cdof_dot = tkin.com_vel(tm, com, v)
    trest = dict(cvel=cvel, mass_center=tkin.mass_center(tm, kin),
                 M=tdyn.crb(tm, com),
                 bias=tdyn.rne(tm, com, cvel, cdof_dot, v))
    errs = {}
    for name, want, got in (("kin", jkin_, kin), ("com", jcom, com)):
        for f in want._fields:
            errs[f"{name}.{f}"] = _err(getattr(want, f),
                                       getattr(got, f).numpy())
    errs.update({k: _err(jrest[k], trest[k].numpy()) for k in jrest})
    bad = {k: e for k, e in errs.items() if not e < TOL}
    assert not bad, bad


TIE = 1e-6   # m: depths closer than this are ordered by rounding alone


def _jax_depths(jm, tables, qpos):
    """(B, total_slots) depth (dist - margin, proxy gaps applied) of every
    pair slot, from the JAX package's narrow phase."""
    margin = np.concatenate([g.margin for g in tables])
    gap = np.concatenate([g.gap for g in tables])
    with jax.default_matmul_precision("highest"):
        d = jax.jit(jax.vmap(lambda q: jnp.concatenate(
            [g[0] for g in jcol._narrow_groups(
                jm, tables, jkin.fwd_kinematics(jm, q))])))(
                    jnp.asarray(qpos))
    return np.asarray(d, np.float64) - gap - margin


def assert_same_contact_set(want, got, depth):
    """The active contacts (depth < 0) are identical, slot for slot; the
    rest of the top-K list is identical too except where two slots' depths
    lie within TIE of each other: there float32 rounding alone orders
    them, and each slot the port put at a position must be as deep, in
    the JAX package's own depths, as the one the JAX package put there."""
    ws, gs = np.asarray(want.slot_idx), got.slot_idx.numpy()
    active = np.asarray(want.dist) < np.asarray(want.includemargin)
    for f in ("slot_idx", "geom1", "geom2", "condim"):
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        np.testing.assert_array_equal(b[active], a[active], err_msg=f)
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))
    rows = np.arange(len(ws))[:, None]
    gap = np.abs(depth[rows, gs] - depth[rows, ws])
    assert gap.max() < TIE, gap.max()
    return int((ws != gs).sum())


def test_g1_collide_matches_with_plane_mesh(setup):
    """The engines' own (proxy-calibrated) tables; the prone pose sinks
    past the 24 slots, so the top-K tie rule and overflow are held too."""
    jm, tm, je, te, qpos, _, _ = setup
    plane_mesh = [g for g in te.tables if g.kind == tcol.K_PLANE_MESH]
    assert len(plane_mesh) == 1
    mesh_ids = list(int(g) for g in plane_mesh[0].g2)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax.vmap(lambda q: jcol.collide(
            jm, je.tables, jkin.fwd_kinematics(jm, q), K)))(
                jnp.asarray(qpos))
    got = tcol.collide(tm, te.tables,
                       tkin.fwd_kinematics(tm, torch.tensor(qpos)), K)
    active = np.asarray(want.dist) < np.asarray(want.includemargin)
    assert active[4:].any(1).all()
    assert int(np.asarray(want.overflow)[-1]) > 0, \
        "the prone pose did not saturate the slots"
    # mesh hulls touch the floor in the sunk poses
    assert (np.isin(np.asarray(want.geom2), mesh_ids) & active).any()
    assert_same_contact_set(want, got, _jax_depths(jm, je.tables, qpos))
    same = np.asarray(want.slot_idx) == got.slot_idx.numpy()
    assert same.mean() > 0.95
    for f in ("dist", "pos", "frame", "includemargin", "friction", "solref",
              "solimp"):
        e = _err(np.asarray(getattr(want, f))[same],
                 getattr(got, f).numpy()[same])
        assert e < TOL, (f, e)
    # at a rounding tie the two slots are as deep as each other
    assert _err(want.dist, got.dist.numpy()) < TOL


def test_plane_mesh_vertex_table_pads_with_first_vertex(setup):
    """Hull vertices are padded to the largest count with each mesh's
    first vertex, as the JAX package pads them: the duplicates stay, so
    a short mesh may fill several of its 4 slots with one vertex. (The
    G1's hulls all have 32 vertices; a stub model holds a short one.)"""
    from types import SimpleNamespace

    r = np.random.RandomState(2)
    v_long, v_short = r.randn(7, 3), r.randn(3, 3)
    m = SimpleNamespace(meshes=[SimpleNamespace(verts=v_long),
                                SimpleNamespace(verts=v_short)],
                        geom_meshid=np.array([-1, 1, 0]))
    verts = tcol._hull_verts(m, [1, 2])
    assert verts.shape == (2, 7, 3)
    np.testing.assert_array_equal(verts[1], v_long)
    np.testing.assert_array_equal(verts[0, :3], v_short)
    np.testing.assert_array_equal(verts[0, 3:], np.tile(v_short[:1], (4, 1)))
    tm, grp = setup[1], [g for g in setup[3].tables
                          if g.kind == tcol.K_PLANE_MESH][0]
    assert tcol._hull_verts(tm, grp.g2).shape == (len(grp.g2), 32, 3)


def _step_errs(je, te, step, qpos, qvel, ctrl, n_steps, lam0s=None,
               ties=False, jax_cold=False):
    """``n_steps`` of both engines from the same state and ctrl (the JAX
    one through the jitted ``step``): the active contact slots must
    agree at every step, position for position (with ``ties``, up to the
    order of two active slots whose JAX depths lie within TIE: float32
    rounding alone orders them); returns the scaled errors after the
    last one. With ``lam0s`` (a list), the warm start the port's solve
    receives at each step is appended to it. With ``jax_cold``, the JAX
    step is given the empty carry at every step."""
    B = len(qpos)
    jq, jv = jnp.asarray(qpos), jnp.asarray(qvel)
    jl = jl_empty = jnp.tile(je.empty_lam()[None], (B, 1))
    tq_, tv, tl = torch.tensor(qpos), torch.tensor(qvel), te.empty_lam(B)
    jc, tc = jnp.asarray(ctrl), torch.tensor(ctrl)
    entry = tsolver.fused_solve_parts
    if lam0s is not None:
        tsolver.fused_solve_parts = lambda *a, **k: (
            lam0s.append(a[-1].clone()) or entry(*a, **k))
    try:
        for _ in range(n_steps):
            jq, jv, jd = step(jq, jv, jc, jl_empty if jax_cold else jl)
            jl = jd.lam
            tq_, tv, td = te.step(tq_, tv, tc, lam0=tl)
            tl = td.lam
            jdist = np.asarray(jd.contacts.dist)
            act = jdist < np.asarray(jd.contacts.includemargin)
            ws = np.asarray(jd.contacts.slot_idx)
            gs = td.contacts.slot_idx.numpy()
            if ties:
                for e in range(B):
                    assert sorted(gs[e][act[e]]) == sorted(ws[e][act[e]]), e
                    for s in np.flatnonzero(act[e] & (gs[e] != ws[e])):
                        j = np.flatnonzero(ws[e] == gs[e, s])[0]
                        assert abs(jdist[e, j] - jdist[e, s]) < TIE, (e, s)
            else:
                np.testing.assert_array_equal(gs[act], ws[act])
    finally:
        tsolver.fused_solve_parts = entry
    # the carried forces; the carried slot ids of inactive slots may
    # differ at rounding ties (they carry zero force in both)
    nl = 3 * te.k_slots + 37
    return {"qpos": _err(jq, tq_.numpy()), "qvel": _err(jv, tv.numpy()),
            "qacc": _err(jd.qacc, td.qacc.numpy()),
            "qfrc_constraint": _err(jd.qfrc_constraint,
                                    td.qfrc_constraint.numpy()),
            "lam": _err(np.asarray(jl)[:, :nl], tl.numpy()[:, :nl])}


@pytest.mark.parametrize("n_steps", [1, 5])
def test_g1_engine_steps_match(setup, jax_step, n_steps):
    _, _, je, te, qpos, qvel, ctrl = setup
    assert te.n_constraint_rows == je.n_constraint_rows == 3 * K + 37 == 109
    assert te.n_warm_rows == je.n_warm_rows
    errs = _step_errs(je, te, jax_step, qpos, qvel, ctrl, n_steps)
    bad = {k: v for k, v in errs.items() if not v < TOL_STEP}
    assert not bad, bad


def test_g1_engine_step_at_128_contacts(setup):
    """Euler steps of the nine states with 128 contact slots (the size
    the card's shared-memory plan takes) against the JAX engine at the
    same max_contacts: the prone pose, which drops contacts at 24 slots,
    drops none, and the states agree at TOL_STEP after one step and
    after a second one warm-started through the 128 x 128 pair-keyed
    gather."""
    jm, tm, _, _, qpos, qvel, ctrl = setup
    je = JEngine(jm, max_contacts=128, integrator=EULER)
    te = Engine(tm, max_contacts=128, integrator=EULER, device="cpu")
    assert te.n_constraint_rows == je.n_constraint_rows == 3 * 128 + 37
    assert te.k_slots == 128
    fk = tkin.fwd_kinematics(tm, torch.tensor(qpos))
    for k, dropped in ((K, True), (128, False)):
        ov = tcol.collide(tm, te.tables, fk, k).overflow.numpy()
        assert (ov[-1] > 0) == dropped, (k, ov)
    c128 = tcol.collide(tm, te.tables, fk, 128)
    assert not c128.overflow.numpy().any()
    active = (c128.dist < c128.includemargin).sum(1).numpy()
    assert active[-1] > K, active
    step = jax.jit(jax.vmap(je.step))
    for n_steps in (1, 2):
        lam0s = []
        errs = _step_errs(je, te, step, qpos, qvel, ctrl, n_steps, lam0s,
                          ties=True)
        bad = {k: v for k, v in errs.items() if not v < TOL_STEP}
        assert not bad, (n_steps, bad)
    assert float(lam0s[-1].abs().max()) > 0, "no warm start"


# the engine options of the recorded fine-tune recipes and their
# neighbour (tools/train_queue_r5c.sh: --no-warm-start-lam
# --mesh-subcapsules 1); the default is 2 subcapsules, warm-started
ENGINE_OPTIONS = {
    "subcapsules_1": dict(mesh_subcapsules=1),
    "subcapsules_3": dict(mesh_subcapsules=3),
    "no_warm_start": dict(warm_start_lam=False),
}


@pytest.mark.parametrize("option", sorted(ENGINE_OPTIONS))
def test_g1_engine_options_match(setup, jax_step, option):
    """3 Euler steps of the 9 states under each option, against the JAX
    package's engine (at one subcapsule a walk pose holds two active
    contacts 1e-8 m deep, ordered by rounding). The subcapsule counts
    change the pair tables, so the JAX engine is built with each. Without
    the warm start the JAX step hands its forward no lam0
    (``physics/step.py:311-313``), so the solve starts from zero forces,
    which is what its default step (the module's compile) makes of the
    empty carry: that is the reference, and the port's engine, built with
    ``warm_start_lam=False`` and given the carried lam, must start its
    solve from lam0 = 0 at every step."""
    jm, tm, je, _, qpos, qvel, ctrl = setup
    kw = ENGINE_OPTIONS[option]
    cold = "warm_start_lam" in kw
    if not cold:
        je = JEngine(jm, max_contacts=K, integrator=EULER, **kw)
    te = Engine(tm, max_contacts=K, integrator=EULER, device="cpu", **kw)
    assert te.n_constraint_rows == je.n_constraint_rows == 109
    assert [len(g.g1) for g in te.tables] == [len(g.g1) for g in je.tables]
    lam0s = []
    step = jax_step if cold else jax.jit(jax.vmap(je.step))
    errs = _step_errs(je, te, step, qpos, qvel, ctrl, 3, lam0s, ties=True,
                      jax_cold=cold)
    bad = {k: v for k, v in errs.items() if not v < TOL_STEP}
    assert not bad, bad
    assert len(lam0s) == 3
    warm = [float(x.abs().max()) for x in lam0s[1:]]
    if cold:
        assert warm == [0.0, 0.0]
    else:
        assert all(w > 0 for w in warm), warm


def test_g1_parts_plain_matches_pallas_interpret(setup):
    """The parts entry's plain version on the inputs a G1 engine step
    gives the solve (two sunk walk poses, warm-started from the step
    before), against the JAX package's Pallas kernel in interpret mode
    (the kernel the CUDA one replaces)."""
    _, _, _, te, qpos, qvel, ctrl = setup
    q, v, u = (torch.tensor(x[4:6]) for x in (qpos, qvel, ctrl))
    captured = []
    entry = tsolver.fused_solve_parts

    def record(*args, **kw):
        captured.append(([a.clone() for a in args], dict(kw)))
        return entry(*args, **kw)

    tsolver.fused_solve_parts = record
    try:
        q, v, d = te.step(q, v, u, lam0=te.empty_lam(2))
        te.step(q, v, u, lam0=d.lam)  # a second step: nonzero warm start
    finally:
        tsolver.fused_solve_parts = entry
    args, kw = captured[-1]
    assert (kw["K"], kw["L"], kw["iterations"]) == (24, 37, 50)
    assert float(args[-1].abs().max()) > 0, "no warm start"
    assert float(args[-3][:, :24].sum()) > 0, "no active contact"
    want = jax.vmap(lambda *x: fused_solve_parts_single(
        *x, K=24, L=37, ld_idx=kw["ld_idx"], iterations=50,
        pyramidal=False, interpret=True))(*[jnp.asarray(x.numpy())
                                            for x in args])
    got = fs.fused_solve_parts(*args, **kw)
    for name, w, g in zip(("qacc", "qfrc", "lam"), want, got):
        e = _err(w, g.numpy())
        assert e < TOL_KERNEL, (name, e)


@pytest.mark.parametrize("name", sorted(ACTORS))
def test_g1_gate_actor_npz_matches_orbax_checkpoint(name):
    from deepmimic_mujoco_tpu.rl.checkpoint import restore_params

    p = restore_params(os.path.join(_REPO, ACTORS[name]))["params"]
    npz = np.load(os.path.join(_REPO, "deepmimic_mujoco_tpu_torch", "data",
                               f"g1_{name}_gate_actor.npz"))
    assert sorted(npz.files) == ["b0", "b1", "b2", "log_std",
                                 "w0", "w1", "w2"]
    for i in range(3):
        np.testing.assert_array_equal(npz[f"w{i}"],
                                      np.asarray(p[f"Dense_{i}"]["kernel"]))
        np.testing.assert_array_equal(npz[f"b{i}"],
                                      np.asarray(p[f"Dense_{i}"]["bias"]))
    np.testing.assert_array_equal(npz["log_std"], np.asarray(p["log_std"]))
    assert npz["w0"].shape == (85, 256) and npz["w2"].shape == (128, 23)
