"""Port parity: rendering against the JAX package.

- ``_scene_tables``: every table equal in value and dtype to the JAX
  package's, at humanoid3d and G1, with scipy's hulls (every G1 mesh
  geom is drawn as hull triangles) and without (the proxy capsules).
- ``draw_poses`` from the JAX FK's geom poses: the frame is byte-
  identical to the JAX ``render_state``'s, overlay included (160x120).
- ``render_state`` end to end, the port's FK on the CPU: at most 0.1% of
  the pixels differ from the JAX ``render_state``'s frame (the two FKs'
  poses differ by ~1e-7, which moves a few edge pixels).
- The viewer headless, driven as ``tests/test_tools_and_rl.py`` drives
  the JAX one.
- ``policy_source``: qpos over 5 frames within 1e-5 scaled (max|d| /
  max(max|ref|, 1)) of the JAX ``policy_source``'s, from the JAX gate
  params carried across by ``rl/convert.py`` and the JAX reset's start
  frame.
- ``eval_dashboard_rollout(render=True, max_steps=8)`` from the same
  start: the CSV rows' step and length equal and ep_rew within 1e-4,
  the same frame count in both mp4s, both plots and the best params.
- ``check_debug_log`` on one dump through both packages: both plots, the
  same frame count in both videos, decoded first frames within a mean
  |d| of 1 intensity level.
- The ray tracer's source is the JAX package's, byte for byte, built with
  its flags; its library is loaded from ``build/torch_kernels/``; the
  matplotlib sketch is taken only without g++; a failed compile raises
  with g++'s output.

The JAX package's ray tracer is built by its own ``rasterizer_lib`` into
a temporary file here, so no test writes its tracked library; the JAX
package's id-keyed table caches forget this module's models when it
ends.
"""
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepmimic_mujoco_tpu.native as jnative
from deepmimic_mujoco_tpu.envs import DPEnv as JDPEnv
from deepmimic_mujoco_tpu.models import assets as jassets
from deepmimic_mujoco_tpu.models import load_model as jload_model
from deepmimic_mujoco_tpu.physics import fwd_kinematics as jfk
from deepmimic_mujoco_tpu.rl import networks as jnet
from deepmimic_mujoco_tpu.rl.checkpoint import restore_params as jrestore
from deepmimic_mujoco_tpu.tools import render as jrender

from deepmimic_mujoco_tpu_torch import native
from deepmimic_mujoco_tpu_torch.envs import DPEnv
from deepmimic_mujoco_tpu_torch.mocap import load_clip
from deepmimic_mujoco_tpu_torch.models import load_model
from deepmimic_mujoco_tpu_torch.rl import checkpoint
from deepmimic_mujoco_tpu_torch.rl.convert import params_from_flax
from deepmimic_mujoco_tpu_torch.tools import render

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_CKPT = os.path.join(
    _REPO, "runs/walk_test20260817-1649_40_videos/"
    "walk_test20260817-1649_40_best")
W, H = 160, 120
MAX_DIFF_SHARE = 1e-3
TOL_QPOS = 1e-5


@pytest.fixture(scope="module", autouse=True)
def forget_jax_model_tables():
    """The JAX package caches per-model tables under ``id(model)``
    (``physics/kinematics.py:_TREE_CACHE``, ``tools/render.py:
    _SCENE_CACHE``). Once this module's models are gone, a model made
    later in the same process can get one of their ids and be served
    their tables (a humanoid3d model the G1's). So the entries this
    module added are dropped when it ends."""
    from deepmimic_mujoco_tpu.physics import kinematics as jkin
    from deepmimic_mujoco_tpu.tools import render as jrender_mod

    caches = (jkin._TREE_CACHE, jrender_mod._SCENE_CACHE)
    before = [set(c) for c in caches]
    yield
    for cache, keys in zip(caches, before):
        for key in set(cache) - keys:
            del cache[key]


@pytest.fixture(scope="module", autouse=True)
def jax_rasterizer(tmp_path_factory):
    """The JAX package's own builder, writing into a temporary file."""
    so, lib = jnative._SO, jnative._lib
    if lib is None:
        jnative._SO = str(tmp_path_factory.mktemp("jax_native")
                          / "librasterizer.so")
    yield
    jnative._SO, jnative._lib = so, lib


@pytest.fixture(scope="module")
def models():
    """{robot: (JAX model, port model, a fixed qpos)}, built on first
    use: humanoid3d at walk frame 10, G1 at its first keyframe."""
    cache = {}

    def get(robot):
        if robot not in cache:
            path = jassets.xml_path(robot)
            jm, tm = jload_model(path), load_model(path)
            q = (tm.key_qpos[0] if robot == "unitree_g1" else load_clip(
                jassets.mocap_path(robot, "walk"), tm).qpos[10])
            cache[robot] = (jm, tm, np.asarray(q, np.float32))
        return cache[robot]
    return get


@pytest.fixture(scope="module")
def h3d_envs():
    return (JDPEnv(motion="walk", robot="humanoid3d"),
            DPEnv(motion="walk", robot="humanoid3d", device="cpu"))


@pytest.fixture(scope="module")
def gate(h3d_envs, tmp_path_factory):
    """The h3d walk gate params (JAX tree), the same in the port's params
    file, and the frame the JAX reset draws from PRNGKey(0)."""
    from deepmimic_mujoco_tpu_torch.rl.networks import ActorCritic

    params = jax.tree.map(np.asarray, jrestore(GATE_CKPT))
    tenv = h3d_envs[1]
    net = ActorCritic(tenv.obs_size, tenv.action_size, device="cpu")
    net.load_state_dict(params_from_flax(params))
    path = checkpoint.save_params(
        str(tmp_path_factory.mktemp("gate") / "gate.pt"), net)
    state, _ = jax.jit(h3d_envs[0].reset)(jax.random.PRNGKey(0))
    return params, path, int(state.idx_curr)


def _force_start(monkeypatch, env, idx):
    monkeypatch.setattr(env, "_draw_frames", lambda n, g: torch.full(
        (n,), idx, dtype=torch.int64, device=env.device))


def _jax_poses(jm, q):
    kin = jax.jit(lambda x: jfk(jm, x))(jnp.asarray(q))
    return np.asarray(kin.geom_xpos), np.asarray(kin.geom_xmat)


@pytest.mark.parametrize("hull", [True, False])
@pytest.mark.parametrize("robot", ["humanoid3d", "unitree_g1"])
def test_scene_tables_match_jax(models, monkeypatch, robot, hull):
    jm, tm, _ = models(robot)
    if not hull:
        monkeypatch.setattr(jrender, "_mesh_hull_tris", lambda mesh: None)
        monkeypatch.setattr(render, "_mesh_hull_tris", lambda mesh: None)
    jrender._SCENE_CACHE.pop(id(jm), None)
    tm.__dict__.pop("_render_tables", None)
    try:
        want, got = jrender._scene_tables(jm), render._scene_tables(tm)
    finally:
        jrender._SCENE_CACHE.pop(id(jm), None)
        tm.__dict__.pop("_render_tables", None)
    assert len(want) == len(got) == 9
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    meshes = np.asarray(tm.geom_type) == 7
    if robot == "unitree_g1":
        assert meshes.sum() > 0
        tri_cnt = got[7]
        if hull:
            assert (tri_cnt[meshes] > 0).all() and (got[0][meshes] == 7).all()
        else:
            assert (tri_cnt == 0).all() and (got[0][meshes] == 3).all()


@pytest.mark.parametrize("robot", ["humanoid3d", "unitree_g1"])
def test_draw_from_jax_poses_is_byte_identical(models, robot):
    jm, tm, q = models(robot)
    want = jrender.render_state(jm, q, mode="rgb_array", overlay="12 3.45",
                                width=W, height=H)
    gx, gm = _jax_poses(jm, q)
    got = render.draw_poses(tm, gx, gm, q[:3], "12 3.45", W, H)
    assert got.shape == (H, W, 3) and got.dtype == np.uint8
    assert got.std() > 20
    np.testing.assert_array_equal(got, want)
    # poses of the wrong shape never reach the ray tracer
    for bad in ((gx[1:], gm), (gx, gm[:, :2])):
        with pytest.raises(ValueError, match="geom poses"):
            render.draw_poses(tm, *bad, q[:3], "", W, H)
    with pytest.raises(ValueError, match="pixels"):
        render.draw_poses(tm, gx, gm, q[:3], "", 0, H)


@pytest.mark.parametrize("robot", ["humanoid3d", "unitree_g1"])
def test_render_state_end_to_end_matches_jax(models, robot):
    jm, tm, q = models(robot)
    want = jrender.render_state(jm, q, mode="rgb_array", width=W, height=H,
                                azimuth_deg=120.0, distance=2.5)
    got = render.render_state(tm, torch.as_tensor(q), mode="rgb_array",
                              width=W, height=H, azimuth_deg=120.0,
                              distance=2.5, device="cpu")
    share = (got != want).any(-1).mean()
    assert share <= MAX_DIFF_SHARE, share
    # the FK the port draws from is the JAX FK's within float32 rounding
    gx, gm = render.geom_poses(tm, q, "cpu")
    jx, jmat = _jax_poses(jm, q)
    np.testing.assert_allclose(gx, jx, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gm, jmat, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="render mode"):
        render.render_state(tm, q, mode="bad", width=8, height=8,
                            device="cpu")


def test_viewer_headless(h3d_envs):
    from deepmimic_mujoco_tpu_torch.tools.view import Viewer, mocap_source

    env = h3d_envs[1]
    src, n = mocap_source(env)
    assert n == env.mocap_data_len
    v = Viewer(env.model, src, width=W, height=H, device="cpu")
    f0 = v.step_once()
    assert f0.shape == (H, W, 3) and v.frame_idx == 1
    v.handle_key("a")
    v.handle_key("w")
    assert v.azimuth == 145.0 and v.distance == 2.75
    f1 = v.step_once()
    assert f1.shape == (H, W, 3)
    # camera moved and the clip advanced: frames must differ
    assert np.abs(f1.astype(int) - f0.astype(int)).mean() > 0.5
    v.handle_key(" ")  # pause
    idx = v.frame_idx
    v.step_once()
    assert v.frame_idx == idx  # paused: no advance
    v.handle_key("right")
    assert v.frame_idx == idx + 1  # scrub while paused
    v.handle_key("left")
    assert v.frame_idx == idx
    for key, attr, want in (("up", "speed", 1.5), ("down", "speed", 1.0),
                            ("s", "distance", 3.0), ("d", "azimuth", 155.0)):
        v.handle_key(key)
        assert getattr(v, attr) == pytest.approx(want)
    v.handle_key("q")
    assert v.quit


def test_policy_source_matches_jax(h3d_envs, gate, monkeypatch):
    from deepmimic_mujoco_tpu.tools.view import policy_source as jsource

    from deepmimic_mujoco_tpu_torch.tools.view import policy_source

    jenv, tenv = h3d_envs
    _, path, idx0 = gate
    _force_start(monkeypatch, tenv, idx0)
    jsrc = jsource(jenv, GATE_CKPT)
    tsrc = policy_source(tenv, path)
    for i in range(5):
        want, got = np.asarray(jsrc(i), np.float64), tsrc(i)
        err = np.abs(want - got).max() / max(np.abs(want).max(), 1.0)
        assert err < TOL_QPOS, (i, err)
    # frame 0 starts the episode again
    np.testing.assert_array_equal(tsrc(0), policy_source(tenv, path)(0))


def _video_frames(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return frames


def test_eval_dashboard_matches_jax(h3d_envs, gate, monkeypatch, tmp_path):
    from deepmimic_mujoco_tpu.rl.eval import (
        eval_dashboard_rollout as jdashboard,
    )

    from deepmimic_mujoco_tpu_torch.rl import networks
    from deepmimic_mujoco_tpu_torch.rl.eval import eval_dashboard_rollout

    jenv, tenv = h3d_envs
    params, _, idx0 = gate
    _force_start(monkeypatch, tenv, idx0)
    jppo = types.SimpleNamespace(env=jenv,
                                 net=jnet.ActorCritic(jenv.action_size))
    net = networks.ActorCritic(tenv.obs_size, tenv.action_size, device="cpu")
    net.load_state_dict(params_from_flax(params))
    jtr = jdashboard(jppo, params, 16, "walk", out_dir=str(tmp_path / "j"),
                     render=True, max_steps=8)
    ttr = eval_dashboard_rollout(types.SimpleNamespace(env=tenv), net, 16,
                                 "walk", out_dir=str(tmp_path / "t"),
                                 render=True, max_steps=8)
    assert jtr["ep_len"] == ttr["ep_len"] == 8
    rows = {}
    for side in "jt":
        d = tmp_path / side / "walk_videos"
        assert all((d / f).exists() for f in (
            "rew_plot.png", "len_plot.png", "global_step_16.mp4"))
        lines = (d / "log.csv").read_text().splitlines()
        assert lines[0] == "global_step,ep_len,ep_rew" and len(lines) == 2
        rows[side] = lines[1].split(",")
        rows[side + "frames"] = _video_frames(d / "global_step_16.mp4")
    assert (tmp_path / "t" / "walk_videos" / "walk_best.pt").exists()
    assert rows["j"][:2] == rows["t"][:2] == ["16", "8"]
    assert abs(float(rows["j"][2]) - float(rows["t"][2])) < 1e-4
    assert len(rows["jframes"]) == len(rows["tframes"]) == 8
    assert rows["tframes"][0].shape == (600, 800, 3)


def test_evaluator_redraws_plots_at_every_eval(h3d_envs, gate, monkeypatch,
                                               tmp_path):
    """A rendering evaluator redraws rew_plot.png and len_plot.png at
    every evaluation, also one queued without its video (the training
    CLI's four evaluations of five), as the JAX package redraws them at
    every evaluation; an evaluator without ``render`` draws no plot and
    no video. Exact: which files exist, and that the second evaluation
    changed the plots' bytes."""
    from deepmimic_mujoco_tpu_torch.rl import networks
    from deepmimic_mujoco_tpu_torch.rl.eval import ThreadedEvaluator

    tenv = h3d_envs[1]
    _force_start(monkeypatch, tenv, gate[2])
    torch.manual_seed(0)
    make = lambda: networks.ActorCritic(tenv.obs_size, tenv.action_size,
                                        device="cpu")
    net, ppo = make(), types.SimpleNamespace(env=tenv, make_net=make)

    def evaluate(out, default, n, render):
        ev = ThreadedEvaluator(ppo, "walk", out_dir=str(tmp_path / out),
                               render=default)
        ev.queue_eval(net, n, render=render)
        ev.stop()
        assert not ev.errors, ev.errors
        return tmp_path / out / "walk_videos"

    plots = ("rew_plot.png", "len_plot.png")
    d = evaluate("on", True, 16, None)
    first = [(d / f).read_bytes() for f in plots]
    assert (d / "global_step_16.mp4").exists()
    evaluate("on", True, 32, False)
    assert not (d / "global_step_32.mp4").exists()
    assert len((d / "log.csv").read_text().splitlines()) == 3
    assert all((d / f).read_bytes() != b for f, b in zip(plots, first))
    d = evaluate("off", False, 16, None)
    assert (d / "log.csv").exists()
    assert not any((d / f).exists()
                   for f in (*plots, "global_step_16.mp4"))


def test_check_debug_log_matches_jax(tmp_path, capsys):
    from deepmimic_mujoco_tpu.tools import check_debug_log as jcheck

    from deepmimic_mujoco_tpu_torch.envs.gym_wrapper import GymDPEnv
    from deepmimic_mujoco_tpu_torch.tools import check_debug_log

    g = GymDPEnv(motion="walk", robot="humanoid3d", device="cpu",
                 crash_dump_dir=str(tmp_path))
    g.reset()
    g.reset_model(idx_init=3)
    zero = np.zeros(g.env.action_size)
    for i in range(3):
        g.step(zero, force_state=(g.mocap.qpos[3 + i], g.mocap.qvel[3 + i]))
    _, _, done, info = g.step(zero, force_state=(
        g.mocap.qpos[6], np.full(g.model.nv, 1e6)))
    assert done and info["done_reason"] == "obs_out_of_bounds"
    (dump,) = [p for p in os.listdir(tmp_path) if p.endswith(".json")]
    dump = str(tmp_path / dump)
    assert len(json.load(open(dump))["qpos"]) == 4
    jcheck.main([dump, "--video", str(tmp_path / "j.mp4"),
                 "--plot", str(tmp_path / "j.png")])
    check_debug_log.main([dump, "--video", str(tmp_path / "t.mp4"),
                          "--plot", str(tmp_path / "t.png"),
                          "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("dump: robot=humanoid3d motion=walk steps=4") == 2
    assert (tmp_path / "j.png").exists() and (tmp_path / "t.png").exists()
    jf, tf = _video_frames(tmp_path / "j.mp4"), _video_frames(
        tmp_path / "t.mp4")
    assert len(jf) == len(tf) == 2
    assert np.abs(jf[0].astype(int) - tf[0].astype(int)).mean() < 1.0


def test_rasterizer_source_is_the_jax_packages():
    with open(native.SOURCE, "rb") as a, \
            open(os.path.join(os.path.dirname(jnative.__file__),
                              "rasterizer.cpp"), "rb") as b:
        assert a.read() == b.read()
    assert native.GXX_FLAGS == ["-O2", "-fopenmp", "-shared", "-fPIC"]


def test_rasterizer_library_is_built_into_build_dir():
    lib = native.rasterizer_lib()
    assert lib is not None
    assert os.path.realpath(lib._name) == os.path.realpath(os.path.join(
        _REPO, "build", "torch_kernels", "librasterizer.so"))
    assert "deepmimic_mujoco_tpu/" not in lib._name
    assert native.build() == 0.0          # up to date: nothing built


def test_sketch_only_without_gxx(models, monkeypatch, capsys):
    _, tm, q = models("humanoid3d")
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    frame = render.render_state(tm, q, width=W, height=H, device="cpu")
    assert "matplotlib sketch" in capsys.readouterr().out
    assert frame.shape == (H, W, 3) and frame.std() > 0
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build(force=True)


def test_failed_compile_raises_with_gxx_output(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f() { return undeclared_name; }\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "LIBRARY", str(tmp_path / "lib.so"))
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.build()
    assert not (tmp_path / "lib.so").exists()
