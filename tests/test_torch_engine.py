"""Port parity: Engine.step (semi-implicit Euler, pair-keyed warm start,
elliptic cone) of the torch port vs the JAX package, humanoid3d, CPU.

Both engines start from the same (qpos, qvel, ctrl, lam): walk-clip
frames and random torques made with numpy. The JAX engine solves with
its XLA fallback (explicit inverse); the port with the plain torch
version of its fused kernel (Cholesky) — so one and five steps are held
to max|d|/scale < 5e-3, the end-to-end tolerance of
tests/test_fused_solve.py.
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

from deepmimic_mujoco_tpu_torch.models import load_model
from deepmimic_mujoco_tpu_torch.physics.step import Engine

TOL = 5e-3


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1.0)


@pytest.fixture(scope="module")
def engines():
    path = jassets.xml_path("humanoid3d")
    jm, tm = jload_model(path), load_model(path)
    je = JEngine(jm, max_contacts=16, integrator=EULER)
    te = Engine(tm, max_contacts=16, integrator=EULER, device="cpu")
    clip = jload_clip(jassets.mocap_path("humanoid3d", "walk"), jm)
    frames = np.array([0, 11, 23, 37, 52, 70])
    r = np.random.RandomState(4)
    qpos = clip.qpos[frames].astype(np.float32)
    qpos[:, 2] -= 0.01            # settle into the floor: contacts bind
    qvel = clip.qvel[frames].astype(np.float32)
    ctrl = (r.uniform(-1, 1, (len(frames), jm.nu)) * 60).astype(np.float32)
    step = jax.jit(jax.vmap(je.step))
    return je, te, step, qpos, qvel, ctrl


def test_engine_step_tables(engines):
    je, te = engines[:2]
    assert te.n_constraint_rows == je.n_constraint_rows == 3 * 16 + 28
    assert te.n_warm_rows == je.n_warm_rows


@pytest.mark.parametrize("n_steps", [1, 5])
def test_engine_steps_match(engines, n_steps):
    je, te, step, qpos, qvel, ctrl = engines
    B = len(qpos)
    jq, jv = jnp.asarray(qpos), jnp.asarray(qvel)
    jl = jnp.tile(je.empty_lam()[None], (B, 1))
    tq_, tv = torch.tensor(qpos), torch.tensor(qvel)
    tl = te.empty_lam(B)
    jc, tc = jnp.asarray(ctrl), torch.tensor(ctrl)
    n_active = 0
    for _ in range(n_steps):
        jq, jv, jd = step(jq, jv, jc, jl)
        jl = jd.lam
        tq_, tv, td = te.step(tq_, tv, tc, lam0=tl)
        tl = td.lam
        n_active += int((np.asarray(jd.contacts.dist)
                         < np.asarray(jd.contacts.includemargin)).sum())
        np.testing.assert_array_equal(td.contacts.slot_idx.numpy(),
                                      np.asarray(jd.contacts.slot_idx))
    assert n_active > 0, "no contact bound: the solve was not exercised"
    errs = {"qpos": _err(jq, tq_.numpy()), "qvel": _err(jv, tv.numpy()),
            "qacc": _err(jd.qacc, td.qacc.numpy()),
            "qfrc_constraint": _err(jd.qfrc_constraint,
                                    td.qfrc_constraint.numpy()),
            "lam": _err(jl, tl.numpy())}
    bad = {k: v for k, v in errs.items() if not v < TOL}
    assert not bad, bad
