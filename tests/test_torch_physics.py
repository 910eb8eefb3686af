"""Port parity: kinematics, dynamics and collision of the torch port vs
the JAX package, humanoid3d, on the CPU.

Inputs are walk-clip mocap frames (made with numpy, float32) and
perturbed copies of them lowered into the floor, fed to the JAX
functions (vmapped) and to the port's batch-major functions. Float32
agreement is held to 1e-5 relative to each quantity's scale; the
contact sets — slots, pair ids, overflow — must be identical.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.mocap import load_clip as jload_clip
from deepmimic_mujoco_tpu.models import assets as jassets
from deepmimic_mujoco_tpu.models import load_model as jload_model
from deepmimic_mujoco_tpu.physics import collision as jcol
from deepmimic_mujoco_tpu.physics import dynamics as jdyn
from deepmimic_mujoco_tpu.physics import kinematics as jkin

from deepmimic_mujoco_tpu_torch.models import load_model
from deepmimic_mujoco_tpu_torch.physics import collision as tcol
from deepmimic_mujoco_tpu_torch.physics import dynamics as tdyn
from deepmimic_mujoco_tpu_torch.physics import kinematics as tkin

TOL = 1e-5


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1.0)


@pytest.fixture(scope="module")
def setup():
    path = jassets.xml_path("humanoid3d")
    jm, tm = jload_model(path), load_model(path)
    clip = jload_clip(jassets.mocap_path("humanoid3d", "walk"), jm)
    frames = np.arange(0, len(clip), 9)
    qpos = clip.qpos[frames].astype(np.float32)
    qvel = clip.qvel[frames].astype(np.float32)
    # perturbed copies: joints jittered, root lowered into the floor
    r = np.random.RandomState(0)
    qp = qpos.copy()
    qp[:, 7:] += r.uniform(-0.15, 0.15, qp[:, 7:].shape).astype(np.float32)
    qp[:, 2] -= r.uniform(0.0, 0.08, len(qp)).astype(np.float32)
    ctrl = r.uniform(-1, 1, (len(qpos), jm.nu)).astype(np.float32) * 100
    return jm, tm, np.concatenate([qpos, qp]), np.concatenate([qvel, qvel]), \
        np.concatenate([ctrl, ctrl])


def _jax_stages(jm, qpos, qvel, ctrl):
    def one(q, v, c):
        kin = jkin.fwd_kinematics(jm, q)
        com = jkin.com_pos(jm, kin)
        cvel, cdof_dot = jkin.com_vel(jm, com, v)
        return dict(
            kin=kin, com=com, cvel=cvel, cdof_dot=cdof_dot,
            mass_center=jkin.mass_center(jm, kin), M=jdyn.crb(jm, com),
            bias=jdyn.rne(jm, com, cvel, cdof_dot, v),
            passive=jdyn.passive_force(jm, q, v),
            act=jdyn.actuator_force(jm, c))
    with jax.default_matmul_precision("highest"):
        return jax.jit(jax.vmap(one))(jnp.asarray(qpos), jnp.asarray(qvel),
                                      jnp.asarray(ctrl))


def _torch_stages(tm, qpos, qvel, ctrl):
    q, v, c = (torch.tensor(x) for x in (qpos, qvel, ctrl))
    kin = tkin.fwd_kinematics(tm, q)
    com = tkin.com_pos(tm, kin)
    cvel, cdof_dot = tkin.com_vel(tm, com, v)
    return dict(
        kin=kin, com=com, cvel=cvel, cdof_dot=cdof_dot,
        mass_center=tkin.mass_center(tm, kin), M=tdyn.crb(tm, com),
        bias=tdyn.rne(tm, com, cvel, cdof_dot, v),
        passive=tdyn.passive_force(tm, q, v),
        act=tdyn.actuator_force(tm, c))


def test_kinematics_and_dynamics_match(setup):
    jm, tm, qpos, qvel, ctrl = setup
    want = _jax_stages(jm, qpos, qvel, ctrl)
    got = _torch_stages(tm, qpos, qvel, ctrl)
    errs = {}
    for k in ("kin", "com"):
        for f in want[k]._fields:
            errs[f"{k}.{f}"] = _err(getattr(want[k], f),
                                    getattr(got[k], f).numpy())
    for k in ("cvel", "cdof_dot", "mass_center", "M", "bias", "passive",
              "act"):
        errs[k] = _err(want[k], got[k].numpy())
    bad = {k: v for k, v in errs.items() if not v < TOL}
    assert not bad, bad


def test_collide_matches(setup):
    jm, tm, qpos, _, _ = setup
    K = 16
    jt = jcol.build_pair_tables(jm, 2)
    tt = tcol.build_pair_tables(tm, 2)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax.vmap(lambda q: jcol.collide(
            jm, jt, jkin.fwd_kinematics(jm, q), K)))(jnp.asarray(qpos))
    got = tcol.collide(tm, tt, tkin.fwd_kinematics(tm, torch.tensor(qpos)), K)
    active = np.asarray(want.dist) < np.asarray(want.includemargin)
    # the perturbed half of the batch touches the floor in every pose
    assert active[len(qpos) // 2:].any(1).all()
    assert active.sum() > len(qpos)
    for f in ("slot_idx", "geom1", "geom2", "condim", "overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("dist", "pos", "frame", "includemargin", "friction", "solref",
              "solimp"):
        e = _err(getattr(want, f), getattr(got, f).numpy())
        assert e < TOL, (f, e)


def test_collide_reports_overflow(setup):
    """With fewer slots than active contacts, both count the drop."""
    jm, tm, qpos, _, _ = setup
    q = qpos[len(qpos) // 2:].copy()
    q[:, 2] -= 0.3          # sink deep: many simultaneous contacts
    jt, tt = jcol.build_pair_tables(jm, 2), tcol.build_pair_tables(tm, 2)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax.vmap(lambda x: jcol.collide(
            jm, jt, jkin.fwd_kinematics(jm, x), 4)))(jnp.asarray(q))
    got = tcol.collide(tm, tt, tkin.fwd_kinematics(tm, torch.tensor(q)), 4)
    assert np.asarray(want.overflow).max() > 0
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))
    np.testing.assert_array_equal(got.slot_idx.numpy(),
                                  np.asarray(want.slot_idx))
