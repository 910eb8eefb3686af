"""Port parity: the single-env tools against the JAX package.

- ``ExtractedPolicy``: the committed artifact's golden-vector test; and
  the port's ``extract_policy`` of a torque net and of a PD net writes
  the arrays and golden JSON that the JAX package's ``extract_policy``
  writes for the same params (the numpy arrays equal, golden actions to
  1e-12, both computed by numpy on equal arrays).
- ``GymDPEnv`` from ``reset_model(idx_init=20)`` against the JAX
  ``GymDPEnv`` for 3 steps of the same actions: obs held to 5e-3 scaled
  (max|d| / max(max|ref|, 1), the end-to-end tolerance of a step through
  the solve, tests/test_torch_env.py), reward and every ``info`` value
  to 5e-3 absolute, done and done_reason equal; a crash dump from a
  forced divergent state has the JAX dump's keys; ``render()`` after the
  steps differs from the JAX wrapper's frame in at most 0.1% of its
  pixels (the two states agree within the step tolerance above, which
  moves a few edge pixels).
- ``GymDPCombinedEnv``: one step from the JAX wrapper's reset state,
  the same tolerances, and ``render()`` as above.
- ``play.main`` at ``--max-steps 5`` with the extracted run artifact on
  the CPU (golden test first); ``--video`` writes an mp4 of every 2nd
  step.
- ``probe`` rows against the JAX ``probe`` for one start over 5 steps
  (ep_len and reason equal, ep_rew, dx and z to 5e-3 absolute).
- ``stage_breakdown`` at batch 4: ``env.step`` and its stages, each a
  non-negative host time; the solve, PPO and sweep harnesses and the
  ``torch.profiler`` trace run at tiny sizes.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepmimic_mujoco_tpu.native as jnative
from deepmimic_mujoco_tpu.envs import GymDPEnv as JGym
from deepmimic_mujoco_tpu.rl import networks as jnet

from deepmimic_mujoco_tpu_torch.envs.gym_wrapper import (
    GymDPCombinedEnv, GymDPEnv,
)
from deepmimic_mujoco_tpu_torch.rl import networks as tnet
from deepmimic_mujoco_tpu_torch.rl.convert import params_from_flax
from deepmimic_mujoco_tpu_torch.rl.extracted_policy import (
    ExtractedPolicy, extract_policy,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(_REPO, "deepmimic_mujoco_tpu_torch", "data")
TOL = 5e-3
N_STEPS = 3
MAX_DIFF_SHARE = 1e-3   # share of a frame's pixels


@pytest.fixture(scope="module", autouse=True)
def jax_rasterizer(tmp_path_factory):
    """The JAX package's ray tracer built by its own builder into a
    temporary file, so no test writes its tracked library."""
    so, lib = jnative._SO, jnative._lib
    if lib is None:
        jnative._SO = str(tmp_path_factory.mktemp("jax_native")
                          / "librasterizer.so")
    yield
    jnative._SO, jnative._lib = so, lib


def _same_frame(jg, tg):
    want, got = jg.render(mode="rgb_array"), tg.render(mode="rgb_array")
    assert got.shape == want.shape == (480, 480, 3)
    share = (got != want).any(-1).mean()
    assert share <= MAX_DIFF_SHARE, share
    assert got.std() > 20


def _frame_count(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    ok, frame = cap.read()
    cap.release()
    assert ok and frame.std() > 0
    return n


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1.0)


@pytest.fixture(scope="module")
def gyms():
    return (JGym(motion="walk", robot="humanoid3d"),
            GymDPEnv(motion="walk", robot="humanoid3d", device="cpu"))


def test_committed_extracted_artifact():
    """The data copy is the committed artifact, and its golden-vector
    test passes in the port's numpy policy."""
    for name in ("run_extracted.npz", "run_extracted_golden.json"):
        with open(os.path.join(DATA, name), "rb") as a, \
                open(os.path.join(_REPO, "runs", name), "rb") as b:
            assert a.read() == b.read(), name
    pol = ExtractedPolicy(os.path.join(DATA, "run_extracted.npz"))
    assert pol.test() and pol.pd is None
    bad = ExtractedPolicy(os.path.join(DATA, "run_extracted.npz"))
    bad.layers[0] = (bad.layers[0][0] * 1.01, bad.layers[0][1])
    with pytest.raises(ValueError):
        bad.test()


def _same_artifacts(jpath, tpath):
    ja, ta = np.load(jpath), np.load(tpath)
    assert sorted(ja.files) == sorted(ta.files)
    for k in ja.files:
        assert ja[k].dtype == ta[k].dtype, k
        np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)
    jg = json.load(open(jpath.replace(".npz", "_golden.json")))
    tg = json.load(open(tpath.replace(".npz", "_golden.json")))
    assert set(jg) == set(tg)
    np.testing.assert_array_equal(jg["obs"], tg["obs"])
    np.testing.assert_allclose(jg["action"], tg["action"], rtol=0,
                               atol=1e-12)


def test_extract_torque_policy_matches_jax(tmp_path):
    from deepmimic_mujoco_tpu.rl.extracted_policy import (
        extract_policy as jextract,
    )

    net = jnet.ActorCritic(action_dim=6, net_arch=(16, 8))
    params = jax.tree.map(np.asarray, net.init(jax.random.PRNGKey(0),
                                               jnp.zeros(10)))
    obs = np.linspace(-1, 1, 10)
    jpath = jextract(params, obs, str(tmp_path / "j.npz"))
    tn = tnet.ActorCritic(10, 6, (16, 8), device="cpu")
    tn.load_state_dict(params_from_flax(params, (16, 8)))
    tpath = extract_policy(tn, obs, str(tmp_path / "t"))
    assert tpath.endswith("t.npz")
    _same_artifacts(jpath, tpath)
    assert ExtractedPolicy(tpath).test()


def test_extract_pd_policy_matches_jax(tmp_path, gyms):
    from deepmimic_mujoco_tpu.rl.extracted_policy import (
        extract_policy as jextract,
    )

    jenv, tgym = gyms[0].env, gyms[1].env
    net = jnet.make_policy("pd", jenv, net_arch=(16, 8))
    params = jax.tree.map(np.asarray, net.init(jax.random.PRNGKey(0),
                                               jnp.zeros(jenv.obs_size)))
    obs = np.random.RandomState(1).randn(jenv.obs_size) * 0.5
    jpath = jextract(params, obs, str(tmp_path / "j.npz"), net=net)
    tn = tnet.make_policy("pd", tgym, net_arch=(16, 8), device="cpu")
    tn.load_state_dict(params_from_flax(params, (16, 8)))
    tpath = extract_policy(tn, obs, str(tmp_path / "t.npz"))
    _same_artifacts(jpath, tpath)
    pol = ExtractedPolicy(tpath)
    assert pol.test() and pol.pd is not None


def _step_both(jg, tg, action, force_state=None):
    jo, jr, jd, ji = jg.step(action, force_state=force_state)
    to, tr, td, ti = tg.step(action, force_state=force_state)
    assert _scaled(jo, to) < TOL
    assert abs(jr - tr) < TOL
    assert jd == td
    assert set(ji) == set(ti)
    for k, v in ji.items():
        if isinstance(v, str):
            assert v == ti[k], k
        else:
            assert abs(v - ti[k]) < TOL, k
    return to, tr, td, ti


def test_gym_env_matches_jax(gyms):
    jg, tg = gyms
    jobs = jg.reset_model(idx_init=20)
    tobs = tg.reset_model(idx_init=20)
    assert _scaled(jobs, tobs) < 1e-5
    assert jg.idx_curr == tg.idx_curr == 20
    np.testing.assert_array_equal(jg.action_space.low, tg.action_space.low)
    np.testing.assert_array_equal(jg.action_space.high,
                                  tg.action_space.high)
    assert jg.observation_space.shape == tg.observation_space.shape
    acts = np.random.RandomState(3).uniform(-0.3, 0.3,
                                            (N_STEPS, tg.env.action_size))
    for a in acts:
        _step_both(jg, tg, a)
    assert jg.episode_length == tg.episode_length == N_STEPS
    assert abs(jg.episode_reward - tg.episode_reward) < N_STEPS * TOL
    assert tg.get_time() == pytest.approx(jg.get_time())
    assert _scaled(jg.sim_qpos, tg.sim_qpos) < TOL
    assert len(tg.episode_debug_log["qpos"]) == N_STEPS
    _same_frame(jg, tg)
    tg.goto(tg.mocap.qpos[5])
    np.testing.assert_array_equal(tg.sim_qpos,
                                  tg.mocap.qpos[5].astype(np.float32))
    assert not tg.sim_qvel.any()


def test_gym_env_crash_dump_matches_jax(gyms, tmp_path):
    jg, tg = gyms
    for g, d in ((jg, "j"), (tg, "t")):
        g.crash_dump_dir = str(tmp_path / d)
        os.makedirs(g.crash_dump_dir)
        g.reset()                  # clears the debug log
        g.reset_model(idx_init=3)
    zero = np.zeros(tg.env.action_size)
    q = tg.mocap.qpos[3]
    _step_both(jg, tg, zero, force_state=(q, tg.mocap.qvel[3]))
    _, _, done, info = _step_both(jg, tg, zero,
                                  force_state=(q, np.full(tg.model.nv, 1e6)))
    assert done and info["done_reason"] == "obs_out_of_bounds"
    (jdump,), (tdump,) = (os.listdir(tmp_path / d) for d in "jt")
    jd = json.load(open(tmp_path / "j" / jdump))
    td = json.load(open(tmp_path / "t" / tdump))
    assert set(jd) == set(td)
    assert {k: td[k] for k in ("full_traceback", "motion", "robot")} == \
        {k: jd[k] for k in ("full_traceback", "motion", "robot")}
    assert len(td["qpos"]) == len(jd["qpos"]) == 2


def test_gym_combined_env_step_matches_jax():
    from deepmimic_mujoco_tpu.envs.gym_wrapper import (
        GymDPCombinedEnv as JCombined,
    )

    jg = JCombined()
    tg = GymDPCombinedEnv(device="cpu")
    jobs = jg.reset()
    tg.reset()
    s = jg._state
    tg._state, tobs = tg.env.reset_to(*(np.array(x)[None] for x in (
        s.qpos, s.qvel, s.motion_id, s.n_steps, s.player_action)))
    assert _scaled(jobs, tobs[0].numpy()) < 1e-5
    assert tg.current_motion_name == jg.current_motion_name
    for a, b in zip(jg.get_current_motion_state(),
                    tg.get_current_motion_state()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_allclose(jg.action_space.high, tg.action_space.high,
                               rtol=1e-7)
    a = np.random.RandomState(4).uniform(-0.3, 0.3, tg.env.action_size)
    _step_both(jg, tg, a)
    assert tg.episode_length == 1
    _same_frame(jg, tg)


def test_play_extracted_on_cpu(capsys, tmp_path):
    from deepmimic_mujoco_tpu_torch.tools import play

    rew = play.main(["--checkpoint", os.path.join(DATA, "run_extracted.npz"),
                     "--motion", "run", "--robot", "unitree_g1",
                     "--max-steps", "5", "--device", "cpu", "--print-js",
                     "--assert-reward", "1"])
    out = capsys.readouterr().out
    assert "golden-vector test OK" in out and "qpos = [" in out
    assert "Episode reward" in out and rew > 1
    # no checkpoint: the zero-torque policy, under RK4, logged as JS
    play.main(["--rk4", "--max-steps", "2", "--log-actobs", "--device",
               "cpu"])
    out = capsys.readouterr().out
    assert "zero-torque" in out and "// step 1" in out
    assert "over 2 steps" in out
    # --video: every 2nd of the 5 steps rendered into the mp4
    video = tmp_path / "play.mp4"
    play.main(["--video", str(video), "--max-steps", "5", "--device",
               "cpu"])
    out = capsys.readouterr().out
    assert "over 5 steps" in out and f"Saved {video}" in out
    assert _frame_count(video) == 3
    with pytest.raises(AssertionError, match="Regression gate failed"):
        play.main(["--max-steps", "2", "--device", "cpu",
                   "--assert-reward", "100"])


def test_probe_matches_jax(gyms):
    from deepmimic_mujoco_tpu.tools.probe import probe as jprobe

    from deepmimic_mujoco_tpu_torch.tools.probe import probe

    jenv, tenv = gyms[0].env, gyms[1].env
    net = jnet.ActorCritic(jenv.action_size)
    params = net.init(jax.random.PRNGKey(2), jnp.zeros(jenv.obs_size))
    tn = tnet.ActorCritic(tenv.obs_size, tenv.action_size, device="cpu")
    tn.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    want = jprobe(jenv, net, params, starts=(40,), max_steps=5)
    # the second start runs beside it in the batch, and its own episode
    # must not change the first one's row
    got = probe(tenv, tn, starts=(40, 3), max_steps=5)
    assert len(got) == 2
    w, g = want[0], got[0]
    assert (w["start"], w["ep_len"], w["reason"]) == \
        (g["start"], g["ep_len"], g["reason"])
    for k in ("ep_rew", "dx", "z"):
        assert abs(w[k] - g[k]) < TOL, k


def test_stage_breakdown_on_cpu(gyms):
    from deepmimic_mujoco_tpu_torch.tools.profiling import stage_breakdown

    rows = stage_breakdown(gyms[1].env, batch=4, steps=2)
    assert [r[0] for r in rows] == [
        "env.step", "engine.collision", "engine.constraints",
        "engine.dynamics", "engine.integrate", "engine.kinematics",
        "engine.solve", "env.done", "env.obs", "env.physics", "env.reset",
        "env.reward"]
    assert all(ms >= 0 and np.isfinite(ms) for _, ms in rows)
    # each stage lies inside its step, so its median under the step's
    assert all(ms <= rows[0][1] for _, ms in rows[1:])


@pytest.mark.parametrize("mode", ["solve", "sweep", "train", "trace"])
def test_profiling_modes_on_cpu(gyms, tmp_path, mode):
    """The other profiling harnesses run on the CPU at tiny sizes (their
    times are the plain versions' on the CPU, not the card's)."""
    from deepmimic_mujoco_tpu_torch.tools import profiling

    env = gyms[1].env
    if mode == "solve":
        rows = profiling.solve_breakdown(env, batch=4)
        assert [r[0] for r in rows][-1] == "forward (engine)"
        assert len(rows) == 5 and all(r[1] > 0 and r[3] == 0 for r in rows)
    elif mode == "sweep":
        rows = profiling.throughput_sweep(env, (2, 4), steps=2)
        assert [b for b, _ in rows] == [2, 4] and all(v > 0 for _, v in rows)
    elif mode == "train":
        rows = profiling.train_breakdown(env, n_envs=4, horizon=2,
                                         epochs=2, minibatch=4, iters=1)
        assert [r[0] for r in rows][:3] == [
            "rollout only", "full iter (1 epochs)", "full iter (2 epochs)"]
        assert len(rows) == 6
    else:
        path = profiling.trace(env, out_dir=str(tmp_path), batch=2, steps=1)
        events = json.load(open(path))["traceEvents"]
        # the program's stages are annotated in the trace
        assert {"env.step", "engine.collision", "engine.solve"} <= {
            e.get("name") for e in events}


def test_resolve_no_card_refuses():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GymDPEnv(motion="walk", robot="humanoid3d")
