"""Port parity for four faults the port had against the JAX package, and
the port held to the MuJoCo 3.10 oracle.

1. ``Engine(iterations=0)`` disables constraints: ``solve_constraints``
   returns qacc_smooth with zero constraint force and zero lam, as the
   JAX package does, even when a warm start is carried in.
2. ``Engine.forward(qpos, qvel, ctrl, h_implicit=0.0, lam0=None)`` has the
   JAX package's signature: its default is the explicit path (M̂ = M,
   tanh frictionloss), ``h_implicit=dt`` the Euler path's implicit terms.
3. ``clip_preserve_inward``'s gradient is the JAX package's custom VJP,
   not a hard clamp's (and the JAX package's behaviour test of it).
4. FK and the humanoid3d floor-contact set against MuJoCo, with the
   tolerances of tests/test_kinematics_parity.py and
   tests/test_collision.py.

JAX runs on the CPU; inputs are numpy arrays made from a seed.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.mocap import load_clip as jload_clip
from deepmimic_mujoco_tpu.models import assets as jassets
from deepmimic_mujoco_tpu.models import load_model as jload_model
from deepmimic_mujoco_tpu.models.physics_model import EULER
from deepmimic_mujoco_tpu.physics.step import Engine as JEngine
from deepmimic_mujoco_tpu.rl import networks as jnet

from deepmimic_mujoco_tpu_torch.models import load_model
from deepmimic_mujoco_tpu_torch.physics import collision as tcol
from deepmimic_mujoco_tpu_torch.physics import kinematics as tkin
from deepmimic_mujoco_tpu_torch.physics.step import Engine
from deepmimic_mujoco_tpu_torch.rl import networks as tnet

TOL = 1e-5
TOL_STEP = 5e-3


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1.0)


@pytest.fixture(scope="module")
def h3d():
    path = jassets.xml_path("humanoid3d")
    jm, tm = jload_model(path), load_model(path)
    clip = jload_clip(jassets.mocap_path("humanoid3d", "walk"), jm)
    frames = np.array([3, 11, 23, 52])
    r = np.random.RandomState(7)
    qpos = clip.qpos[frames].astype(np.float32)
    qpos[:, 2] -= 0.01            # settle into the floor: contacts bind
    qvel = clip.qvel[frames].astype(np.float32)
    ctrl = (r.uniform(-1, 1, (len(frames), jm.nu)) * 60).astype(np.float32)
    je = JEngine(jm, max_contacts=16, integrator=EULER)
    te = Engine(tm, max_contacts=16, integrator=EULER, device="cpu")
    return jm, tm, je, te, qpos, qvel, ctrl


def test_iterations_zero_disables_constraints(h3d):
    """A 50-iteration step gives a warm start; the iterations=0 engines
    then take one step from it. The JAX package applies no constraint
    force there; the port applied one (427.16 at humanoid3d walk frame
    11) before it short-circuited."""
    jm, tm, je50, te50, qpos, qvel, ctrl = h3d
    B = len(qpos)
    je0 = JEngine(jm, max_contacts=16, integrator=EULER, iterations=0)
    te0 = Engine(tm, max_contacts=16, integrator=EULER, iterations=0,
                 device="cpu")
    jq, jv, jc = map(jnp.asarray, (qpos, qvel, ctrl))
    jl = jnp.tile(je50.empty_lam()[None], (B, 1))
    jq, jv, jd = jax.jit(jax.vmap(je50.step))(jq, jv, jc, jl)
    tq_, tv, td = te50.step(*map(torch.tensor, (qpos, qvel, ctrl)),
                            lam0=te50.empty_lam(B))
    assert float(td.qfrc_constraint.abs().max()) > 1.0
    assert float(td.lam[:, :76].abs().max()) > 0.0, "no warm start to carry"
    jq0, jv0, jd0 = jax.jit(jax.vmap(je0.step))(jq, jv, jc, jd.lam)
    tq0, tv0, td0 = te0.step(tq_, tv, torch.tensor(ctrl), lam0=td.lam)
    assert float(np.abs(np.asarray(jd0.qfrc_constraint)).max()) == 0.0
    assert float(td0.qfrc_constraint.abs().max()) == 0.0
    assert float(td0.lam[:, :76].abs().max()) == 0.0
    errs = {"qacc": _err(jd0.qacc, td0.qacc.numpy()),
            "qvel": _err(jv0, tv0.numpy()), "qpos": _err(jq0, tq0.numpy())}
    bad = {k: v for k, v in errs.items() if not v < TOL_STEP}
    assert not bad, bad


@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit-default", "h_implicit-dt"])
def test_forward_matches_reference_signature(h3d, implicit):
    """``forward(q, v, u)`` is the explicit path and ``forward(q, v, u,
    h_implicit=dt)`` the Euler one, in both packages (the port's default
    used to be the implicit one: 1.63e-2 scaled off the JAX default)."""
    _, _, je, te, qpos, qvel, ctrl = h3d
    h = te.dt if implicit else 0.0
    # the fourth positional argument is h_implicit in both
    want = jax.jit(jax.vmap(lambda q, v, u: je.forward(q, v, u, h)))(
        *map(jnp.asarray, (qpos, qvel, ctrl)))
    got = te.forward(*map(torch.tensor, (qpos, qvel, ctrl)), h)
    errs = {k: _err(getattr(want, k), getattr(got, k).numpy())
            for k in ("qacc", "qfrc_smooth", "qfrc_constraint")}
    bad = {k: v for k, v in errs.items() if not v < TOL}
    assert not bad, bad
    assert float(got.qfrc_constraint.abs().max()) > 1.0


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["g+", "g-"])
def test_clip_preserve_inward_gradient_matches_jax(sign):
    """x below lo, on lo, inside, on hi and above hi, against jax's VJP
    of the JAX package's custom rule, for both signs of the incoming
    gradient and random magnitudes."""
    lo, hi = -4.0, 1.0
    x = np.array([-6.0, -4.5, -4.0, -1.0, 0.0, 1.0, 1.5, 3.0], np.float32)
    g = (sign * np.random.RandomState(1).uniform(0.5, 2.0, x.shape)
         ).astype(np.float32)
    want_y, vjp = jax.vjp(lambda v: jnet.clip_preserve_inward(v, lo, hi),
                          jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    y = tnet.clip_preserve_inward(xt, lo, hi)
    y.backward(torch.tensor(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_g))
    # a hard clamp's gradient is zero strictly outside; this one is not
    assert (xt.grad.numpy()[(x < lo) | (x > hi)] != 0).any()


def test_log_std_floor_gradient_reopens():
    """The port of tests/test_tools_and_rl.py::
    test_log_std_floor_gradient_reopens: forward values are clamp's;
    the gradient is blocked only where it points outward, so a raw
    log-std below the floor still gets the entropy's gradient."""
    lo, hi = -1.5, 1.0
    x = torch.tensor([-2.0, -1.5, 0.0, 1.0, 3.0])
    torch.testing.assert_close(tnet.clip_preserve_inward(x, lo, hi),
                               torch.clamp(x, lo, hi), rtol=0, atol=0)
    x.requires_grad_(True)
    tnet.clip_preserve_inward(x, lo, hi).sum().backward()
    assert x.grad.tolist() == [0.0, 1.0, 1.0, 1.0, 1.0]
    x.grad = None
    (-tnet.clip_preserve_inward(x, lo, hi)).sum().backward()
    assert x.grad.tolist() == [-1.0, -1.0, -1.0, -1.0, 0.0]

    net = tnet.ActorCritic(6, 4, net_arch=(8,), log_std_min=lo,
                           device="cpu",
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        net.log_std.fill_(lo - 0.3)
    _, log_std, _ = net(torch.zeros(6))
    (-tnet.gaussian_entropy(log_std)).backward()
    assert (net.log_std.grad < 0).all(), \
        "entropy gradient must re-open a below-floor log_std"


# ---------------- the MuJoCo 3.10 oracle --------------------------------

def test_fk_matches_mujoco():
    """Seeded random humanoid3d states (tests/test_kinematics_parity.py:
    random_state, its tolerances)."""
    mujoco = pytest.importorskip("mujoco")
    path = jassets.xml_path("humanoid3d")
    tm = load_model(path)
    ref = mujoco.MjModel.from_xml_path(path)
    d = mujoco.MjData(ref)
    rng = np.random.default_rng(42)
    qs = []
    for _ in range(4):
        q = rng.normal(size=ref.nq) * 0.5
        q[2] += 1.0
        quat = rng.normal(size=4)
        q[3:7] = quat / np.linalg.norm(quat)
        for j in range(1, ref.njnt):
            lo, hi = ref.jnt_range[j]
            q[ref.jnt_qposadr[j]] = np.clip(q[ref.jnt_qposadr[j]], lo, hi)
        qs.append(q)
    kin = tkin.fwd_kinematics(tm, torch.tensor(np.stack(qs),
                                               dtype=torch.float32))
    for i, q in enumerate(qs):
        d.qpos[:] = q
        mujoco.mj_forward(ref, d)
        np.testing.assert_allclose(kin.xpos[i].numpy(), d.xpos, atol=3e-6)
        dot = np.abs((kin.xquat[i].numpy() * d.xquat).sum(-1))
        np.testing.assert_allclose(dot, 1.0, atol=1e-6)
        np.testing.assert_allclose(kin.geom_xpos[i].numpy(), d.geom_xpos,
                                   atol=3e-6)


def _oracle_pairs(mujoco, ref, q):
    d = mujoco.MjData(ref)
    d.qpos[:] = q
    mujoco.mj_forward(ref, d)
    out = {}
    for i in range(d.ncon):
        c = d.contact[i]
        key = (min(int(c.geom1), int(c.geom2)), max(int(c.geom1),
                                                    int(c.geom2)))
        out.setdefault(key, []).append(float(c.dist))
    return out


def _port_pairs(tm, tables, qs):
    con = tcol.collide(tm, tables, tkin.fwd_kinematics(
        tm, torch.tensor(np.stack(qs), dtype=torch.float32)), 32)
    act = (con.dist < con.includemargin).numpy()
    out = []
    for b in range(len(qs)):
        pairs = {}
        for i in np.where(act[b])[0]:
            g1, g2 = int(con.geom1[b, i]), int(con.geom2[b, i])
            pairs.setdefault((min(g1, g2), max(g1, g2)), []).append(
                float(con.dist[b, i]))
        out.append(pairs)
    return out


def test_floor_contacts_match_mujoco():
    """Standing poses lowered until the foot boxes penetrate the floor:
    the same active pairs, at matching depths (tests/test_collision.py:
    test_feet_on_floor); and the floor pairs of walk-clip frames agree
    with MuJoCo's in > 90% of frames (its mocap-frame test)."""
    mujoco = pytest.importorskip("mujoco")
    path = jassets.xml_path("humanoid3d")
    tm = load_model(path)
    ref = mujoco.MjModel.from_xml_path(path)
    tables = tcol.build_pair_tables(tm)
    stands = []
    for z in (0.83, 0.825):
        q = np.zeros(tm.nq)
        q[2], q[3] = z, 1.0
        stands.append(q)
    for q, ours in zip(stands, _port_pairs(tm, tables, stands)):
        want = _oracle_pairs(mujoco, ref, q)
        assert want and set(ours) == set(want), (ours.keys(), want.keys())
        for key in want:
            dmine, dref = sorted(ours[key]), sorted(want[key])
            assert len(dmine) >= len(dref)
            np.testing.assert_allclose(dmine[:len(dref)], dref, atol=1e-5)
    clip = jload_clip(jassets.mocap_path("humanoid3d", "walk"),
                      jload_model(path))
    frames = list(clip.qpos[::6])
    agree = 0
    for q, ours in zip(frames, _port_pairs(tm, tables, frames)):
        floor_ours = {p for p in ours if 0 in p}
        floor_want = {p for p in _oracle_pairs(mujoco, ref, q) if 0 in p}
        agree += floor_ours == floor_want
    assert agree / len(frames) > 0.9, f"{agree}/{len(frames)}"
