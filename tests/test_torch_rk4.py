"""Port parity: the RK4 integrator, the generic ``integrate_pos`` and the
IMU sensors against the JAX package on the CPU, and the RK4 gate actor.

RK4 runs four explicit forwards per step, each cold-started, so a step
goes through the constraint solve four times: one and five steps of
``Engine.step`` at humanoid3d (batch 4) and one ``DPEnv`` step are held
to 5e-3 scaled, the end-to-end tolerance of tests/test_fused_solve.py
(the JAX package's XLA-fallback solve against the port's Cholesky-based
plain version). The sensors read only position and velocity stages, so
they are held to 1e-5 scaled, against the JAX package (its accelerometer
is an approximation, and the port keeps it).
"""
import copy
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.envs import DPEnv as JDPEnv
from deepmimic_mujoco_tpu.envs.dp_env import DPEnvState as JDPEnvState
from deepmimic_mujoco_tpu.mocap import load_clip as jload_clip
from deepmimic_mujoco_tpu.models import assets as jassets
from deepmimic_mujoco_tpu.models import load_model as jload_model
from deepmimic_mujoco_tpu.models.physics_model import RK4, SLIDE
from deepmimic_mujoco_tpu.physics.sensors import (
    evaluate_sensors as jevaluate_sensors,
)
from deepmimic_mujoco_tpu.physics.step import Engine as JEngine

from deepmimic_mujoco_tpu_torch.envs import DPEnv
from deepmimic_mujoco_tpu_torch.models import load_model
from deepmimic_mujoco_tpu_torch.physics import solver
from deepmimic_mujoco_tpu_torch.physics.sensors import evaluate_sensors
from deepmimic_mujoco_tpu_torch.physics.step import Engine

TOL = 1e-5
TOL_STEP = 5e-3
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RK4_CKPT = os.path.join(_REPO, "runs/walk_test20260817-1918_14_videos/"
                        "walk_test20260817-1918_14_best")
RK4_NPZ = os.path.join(_REPO, "deepmimic_mujoco_tpu_torch", "data",
                       "h3d_walk_rk4_gate_actor.npz")


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1.0)


@pytest.fixture(scope="module")
def h3d():
    path = jassets.xml_path("humanoid3d")
    jm, tm = jload_model(path), load_model(path)
    clip = jload_clip(jassets.mocap_path("humanoid3d", "walk"), jm)
    frames = np.array([3, 20, 41, 66])
    qpos = clip.qpos[frames].astype(np.float32)
    qpos[:, 2] -= 0.01            # settle into the floor: contacts bind
    qvel = clip.qvel[frames].astype(np.float32)
    ctrl = (np.random.RandomState(2).uniform(-1, 1, (len(frames), jm.nu))
            * 60).astype(np.float32)
    return jm, tm, qpos, qvel, ctrl


class _CountSolves:
    """Records the warm start of every constraint solve."""

    def __init__(self, monkeypatch):
        self.lam0 = []
        entry = solver.fused_solve_parts

        def record(*args, **kw):
            self.lam0.append(args[-1].clone())
            return entry(*args, **kw)

        monkeypatch.setattr(solver, "fused_solve_parts", record)


@pytest.fixture(scope="module")
def h3d_envs():
    return (JDPEnv(motion="walk", robot="humanoid3d", integrator=RK4),
            DPEnv(motion="walk", robot="humanoid3d", integrator=RK4,
                  device="cpu"))


@pytest.fixture(scope="module")
def rk4_steps(h3d, h3d_envs):
    """Five RK4 steps from the same states: the JAX package's DPEnv.step
    (whose new state is its Engine.step's, at ctrl = action * act_scale;
    one compile serves the engine and the env tests) against the port's
    Engine.step, with the port's solve warm starts; and the first step's
    env outputs of both."""
    jm, tm, qpos, qvel, ctrl = h3d
    jenv, tenv = h3d_envs
    te = tenv.engine
    assert te.integrator == RK4 and te.single_free_root
    assert te.max_contacts == jenv.engine.max_contacts == 16
    B = len(qpos)
    frames = np.array([3, 20, 41, 66])
    action = (ctrl / tenv.spec.act_scale).astype(np.float32)
    tctrl = tenv._mujoco_action(torch.tensor(action))
    js = JDPEnvState(
        qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
        idx_curr=jnp.asarray(frames, jnp.int32),
        episode_length=jnp.zeros(B, jnp.int32),
        episode_reward=jnp.zeros(B, jnp.float32),
        key=jax.random.split(jax.random.PRNGKey(0), B),
        lam=jnp.tile(jenv.engine.empty_lam()[None], (B, 1)))
    ts = tenv._fresh_state(torch.tensor(frames))._replace(
        qpos=torch.tensor(qpos), qvel=torch.tensor(qvel))
    step = jax.jit(jax.vmap(jenv.step))
    mp = pytest.MonkeyPatch()
    count = _CountSolves(mp)
    try:
        env_out = (step(js, jnp.asarray(action)), tenv.step(
            ts, torch.tensor(action)), count.lam0[:])
        tq_, tv = torch.tensor(qpos), torch.tensor(qvel)
        # a nonzero carried warm start, which RK4 ignores (cold stages)
        tl = torch.ones(B, te.n_warm_rows)
        out = []
        for _ in range(5):
            js, _ = step(js, jnp.asarray(action))
            n0 = len(count.lam0)
            tq_, tv, td = te.step(tq_, tv, tctrl, lam0=tl)
            tl = td.lam
            out.append((js, (tq_, tv, td), count.lam0[n0:]))
    finally:
        mp.undo()
    return out, env_out


@pytest.mark.parametrize("n_steps", [1, 5])
def test_rk4_engine_steps_match_jax(rk4_steps, n_steps):
    steps = rk4_steps[0][:n_steps]
    for js, (_, _, td), lam0 in steps:
        np.testing.assert_array_equal(td.lam.numpy(), np.asarray(js.lam))
        # four cold-started solves per step, none for the data view
        assert len(lam0) == 4
        assert all(bool((x == 0).all()) for x in lam0)
    js, (tq_, tv, td), _ = steps[-1]
    errs = {"qpos": _err(js.qpos, tq_.numpy()),
            "qvel": _err(js.qvel, tv.numpy())}
    bad = {k: v for k, v in errs.items() if not v < TOL_STEP}
    assert not bad, bad
    # the data view is the pre-step state's: no dynamics in it
    assert (td.qacc == 0).all() and (td.qfrc_constraint == 0).all()
    assert n_step_contacts(steps) > 0


def n_step_contacts(steps):
    """Active contacts over the steps: the solve was exercised."""
    return sum(int((td.contacts.dist < td.contacts.includemargin).sum())
               for _, (_, _, td), _ in steps)


def test_generic_integrate_pos_matches_jax_and_fast_path(h3d):
    """A joint table that is not 'free root + hinges' (one hinge relabelled
    a slide, which both packages advance like a hinge) takes the per-joint
    loop in both packages; it equals the fast path."""
    jm, tm, qpos, qvel, _ = h3d
    te = Engine(tm, max_contacts=16, device="cpu")
    jt = np.asarray(jm.jnt_type).copy()
    jt[3] = SLIDE
    jm2 = copy.copy(jm)
    jm2.jnt_type = jt
    tm2 = copy.copy(tm)
    tm2.jnt_type = jt.copy()
    te2 = copy.copy(te)
    te2.m, te2.single_free_root = tm2, False
    r = np.random.RandomState(6)
    v = (qvel + r.randn(*qvel.shape) * 2).astype(np.float32)
    for h in (0.0, 1 / 240, 0.01):
        want = jax.vmap(lambda q, w: JEngine.integrate_pos(
            types.SimpleNamespace(m=jm2), q, w, h))(jnp.asarray(qpos),
                                                    jnp.asarray(v))
        got = te2.integrate_pos(torch.tensor(qpos), torch.tensor(v), h)
        fast = te.integrate_pos(torch.tensor(qpos), torch.tensor(v), h)
        assert _err(want, got.numpy()) < 1e-6, h
        assert _err(fast.numpy(), got.numpy()) == 0, h


def test_rk4_dpenv_step_matches_jax(rk4_steps):
    (js, jo), (ts, to), lam0 = rk4_steps[1]
    assert len(lam0) == 4
    np.testing.assert_array_equal(to.done.numpy(), np.asarray(jo.done))
    np.testing.assert_array_equal(to.done_reason.numpy(),
                                  np.asarray(jo.done_reason))
    np.testing.assert_array_equal(ts.lam.numpy(), np.asarray(js.lam))
    errs = {"obs": _err(jo.obs, to.obs.numpy()),
            "reward": _err(jo.reward, to.reward.numpy()),
            "qpos": _err(js.qpos, ts.qpos.numpy()),
            "qvel": _err(js.qvel, ts.qvel.numpy())}
    bad = {k: v for k, v in errs.items() if not v < TOL_STEP}
    assert not bad, bad


def test_dpenv_force_state_step_matches_jax(h3d, h3d_envs):
    """DPEnv.step(force_state=(qpos, qvel)): no dynamics, the fields fresh
    at the forced state, the empty warm start; held to 1e-5 like a
    reset."""
    _, _, qpos, qvel, _ = h3d
    jenv, tenv = h3d_envs
    frames = np.array([5, 30, 55, 71])
    B = len(frames)
    ts, _ = tenv.reset(B, idx_init=torch.tensor(frames))
    js = JDPEnvState(
        qpos=jenv.mocap_qpos[frames], qvel=jenv.mocap_qvel[frames],
        idx_curr=jnp.asarray(frames, jnp.int32),
        episode_length=jnp.full(B, 3, jnp.int32),
        episode_reward=jnp.zeros(B, jnp.float32),
        key=jax.random.split(jax.random.PRNGKey(0), B),
        lam=jnp.ones((B, jenv.engine.n_warm_rows)))
    ts = ts._replace(episode_length=torch.full((B,), 3),
                     lam=torch.ones(B, tenv.engine.n_warm_rows))
    fq = qpos.copy()
    fq[1, 2] = 0.3                      # below low_z: done
    a = np.zeros((B, tenv.action_size), np.float32)
    js, jo = jax.jit(jax.vmap(lambda s, a, q, v: jenv.step(
        s, a, force_state=(q, v))))(js, jnp.asarray(a), jnp.asarray(fq),
                                    jnp.asarray(qvel))
    ts, to = tenv.step(ts, torch.tensor(a), force_state=(
        torch.tensor(fq), torch.tensor(qvel)))
    np.testing.assert_array_equal(to.done_reason.numpy(),
                                  np.asarray(jo.done_reason))
    assert bool(to.done[1]) and int(to.done_reason[1]) == 1   # low_z
    np.testing.assert_array_equal(ts.lam.numpy(), np.asarray(js.lam))
    np.testing.assert_array_equal(ts.qpos.numpy(), fq)
    np.testing.assert_array_equal(ts.idx_curr.numpy(),
                                  np.asarray(js.idx_curr))
    for k in ("obs", "reward", "vel_match"):
        assert _err(getattr(jo, k), getattr(to, k).numpy()) < TOL, k


def test_g1_sensors_match_jax():
    """gyro, accelerometer and framequat on the G1's IMU site (the
    counterpart of tests/test_sensors.py, held to the JAX package)."""
    path = jassets.xml_path("unitree_g1")
    jm, tm = jload_model(path), load_model(path)
    assert tm.sensor_types == ("gyro", "accelerometer", "framequat")
    r = np.random.RandomState(0)
    qpos = np.tile(np.asarray(jm.key_qpos[0], np.float32), (3, 1))
    qpos[:, 2] += 3.0
    qpos[1, 3:7] = [0.9, 0.1, -0.3, 0.2]
    qpos[1, 3:7] /= np.linalg.norm(qpos[1, 3:7])
    qpos[2, 7:] += r.randn(tm.nq - 7).astype(np.float32) * 0.2
    qvel = (r.normal(size=(3, tm.nv)) * 0.5).astype(np.float32)
    je = JEngine(jm, iterations=0)
    want = jax.jit(jax.vmap(lambda q, v: jevaluate_sensors(
        jm, je.data_view(q, v))))(jnp.asarray(qpos), jnp.asarray(qvel))
    te = Engine(tm, iterations=0, device="cpu")
    got = evaluate_sensors(tm, te.data_view(torch.tensor(qpos),
                                            torch.tensor(qvel)))
    assert set(got) == set(want) == {"gyro_0", "accelerometer_1",
                                     "framequat_2"}
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _err(want[k], got[k].numpy()) < TOL, k
    assert 7.0 < float(torch.linalg.vector_norm(got["accelerometer_1"][0])) \
        < 13.0


def test_rk4_gate_npz_matches_orbax_checkpoint():
    """Provenance of the shipped RK4 gate actor: every array equals the
    committed orbax checkpoint it was exported from."""
    from deepmimic_mujoco_tpu.rl.checkpoint import restore_params

    p = restore_params(RK4_CKPT)["params"]
    npz = np.load(RK4_NPZ)
    assert sorted(npz.files) == ["b0", "b1", "b2", "log_std",
                                 "w0", "w1", "w2"]
    for i in range(3):
        np.testing.assert_array_equal(npz[f"w{i}"],
                                      np.asarray(p[f"Dense_{i}"]["kernel"]))
        np.testing.assert_array_equal(npz[f"b{i}"],
                                      np.asarray(p[f"Dense_{i}"]["bias"]))
    np.testing.assert_array_equal(npz["log_std"], np.asarray(p["log_std"]))
