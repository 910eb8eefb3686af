"""Port parity and behaviour of the training pieces around PPO: the
policy helpers (entropy, the PD-delta policy and ``make_policy``'s
tables at humanoid3d and G1), ``resample_clip_speed`` and
``DPEnv(speed=...)``, the train-state checkpoint (resuming equals
continuing), the params-only and actor artifacts, ``adapt_params``, the
evaluation episode and the training CLI at a tiny size on the CPU.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.envs import DPEnv as JDPEnv
from deepmimic_mujoco_tpu.mocap import load_clip as jload_clip
from deepmimic_mujoco_tpu.mocap.loader import (
    resample_clip_speed as jresample,
)
from deepmimic_mujoco_tpu.models import assets as jassets
from deepmimic_mujoco_tpu.models import load_model as jload_model
from deepmimic_mujoco_tpu.rl import networks as jnet

from deepmimic_mujoco_tpu_torch.envs import DPEnv
from deepmimic_mujoco_tpu_torch.mocap import load_clip
from deepmimic_mujoco_tpu_torch.mocap.loader import resample_clip_speed
from deepmimic_mujoco_tpu_torch.models import load_model
from deepmimic_mujoco_tpu_torch.rl import checkpoint, networks
from deepmimic_mujoco_tpu_torch.rl import eval as rl_eval
from deepmimic_mujoco_tpu_torch.rl.convert import (
    actor_from_npz, params_from_flax,
)
from deepmimic_mujoco_tpu_torch.rl.eval import eval_rollout
from deepmimic_mujoco_tpu_torch.rl.ppo import PPO, PPOConfig
from deepmimic_mujoco_tpu_torch.rl.train import main, parse_reason

TOL = 1e-5


@pytest.fixture(scope="module")
def h3d_envs():
    return (JDPEnv(motion="walk", robot="humanoid3d"),
            DPEnv(motion="walk", robot="humanoid3d", device="cpu"))


def test_gaussian_entropy_matches_jax():
    ls = np.random.RandomState(0).uniform(-3, 1, (5, 7)).astype(np.float32)
    np.testing.assert_allclose(
        networks.gaussian_entropy(torch.tensor(ls)).numpy(),
        np.asarray(jnet.gaussian_entropy(jnp.asarray(ls))), rtol=1e-6)


class _TablesOnly:
    """What make_policy reads of an env, without building its engine."""

    def __init__(self, robot, port):
        from deepmimic_mujoco_tpu.envs.config import DPEnvConfig
        from deepmimic_mujoco_tpu.envs.spec import RobotSpec
        from deepmimic_mujoco_tpu.envs.config import RobotConfig
        from deepmimic_mujoco_tpu_torch.envs import obs as tobs
        from deepmimic_mujoco_tpu_torch.envs.config import (
            DPEnvConfig as TConfig, RobotConfig as TRobot,
        )
        from deepmimic_mujoco_tpu_torch.envs.spec import RobotSpec as TSpec

        path = jassets.xml_path(robot)
        if port:
            self.model = load_model(path)
            self.ENV_CFG = TConfig()
            self.spec = TSpec.build(self.model, TRobot(robot=robot))
            self.obs_size = tobs.obs_size(self.model, self.spec,
                                          self.ENV_CFG)
        else:
            from deepmimic_mujoco_tpu.envs import obs as jobs
            self.model = jload_model(path)
            self.ENV_CFG = DPEnvConfig()
            self.spec = RobotSpec.build(self.model, RobotConfig(robot=robot))
            self.obs_size = jobs.obs_size(self.model, self.spec,
                                          self.ENV_CFG)
        self.action_size = self.model.nu - self.spec.n_hand_actions


@pytest.mark.parametrize("robot", ["humanoid3d", "unitree_g1"])
def test_pd_policy_tables_and_env_action_match_jax(robot):
    jenv, tenv = _TablesOnly(robot, False), _TablesOnly(robot, True)
    jpd = jnet.make_policy("pd", jenv, net_arch=(16,), init_log_std=-1.0)
    tpd = networks.make_policy("pd", tenv, net_arch=(16,),
                               init_log_std=-1.0, device="cpu")
    assert isinstance(tpd, networks.PDTargetActorCritic)
    np.testing.assert_array_equal(tpd.kp.numpy(),
                                  np.asarray(jpd.kp, np.float32))
    np.testing.assert_array_equal(tpd.kd.numpy(),
                                  np.asarray(jpd.kd, np.float32))
    assert tuple(tpd.qvel_cols.tolist()) == tuple(jpd.qvel_cols)
    assert tpd.vel_obs_scale == jpd.vel_obs_scale
    assert tpd.act_scale == jpd.act_scale
    if robot == "unitree_g1":   # arm and hand joints interleave
        assert np.any(np.diff(tpd.qvel_cols.numpy()) != 1)
    tq = networks.make_policy("torque", tenv, net_arch=(16,), device="cpu")
    assert type(tq) is networks.ActorCritic
    # the PD net's params are the torque net's: the flax tree loads
    r = np.random.RandomState(1)
    obs = r.randn(6, jenv.obs_size).astype(np.float32)
    a = r.randn(6, jenv.action_size).astype(np.float32)
    params = jpd.init(jax.random.PRNGKey(0), jnp.zeros(jenv.obs_size))
    tpd.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params),
                                         (16,)))
    want = jpd.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        got = tpd(torch.tensor(obs))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)
    want_e = jnet.env_action(jpd, jnp.asarray(obs), jnp.asarray(a))
    got_e = networks.env_action(tpd, torch.tensor(obs), torch.tensor(a))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e),
                               rtol=1e-6, atol=1e-6)
    # torque policies map actions to themselves
    ta = torch.tensor(a)
    assert networks.env_action(tq, torch.tensor(obs), ta) is ta
    with pytest.raises(ValueError):
        networks.make_policy("bogus", tenv)


@pytest.mark.parametrize("speed", [0.5, 0.75])
def test_resample_clip_speed_matches_jax(speed):
    path = jassets.xml_path("unitree_g1")
    mocap = jassets.mocap_path("unitree_g1", "run")
    jc = jresample(jload_clip(mocap, jload_model(path)), speed)
    tc = resample_clip_speed(load_clip(mocap, load_model(path)), speed)
    assert (tc.motion_name, tc.dt, tc.loop) == (jc.motion_name, jc.dt,
                                                jc.loop)
    np.testing.assert_array_equal(tc.qpos, jc.qpos)
    np.testing.assert_array_equal(tc.qvel, jc.qvel)
    np.testing.assert_allclose(tc.body_xpos, jc.body_xpos, atol=1e-5)
    np.testing.assert_allclose(tc.geom_xpos, jc.geom_xpos, atol=1e-5)
    with pytest.raises(ValueError):
        resample_clip_speed(tc, 0.0)


def test_dpenv_speed_matches_jax():
    je = JDPEnv(motion="walk", robot="humanoid3d", speed=0.5)
    te = DPEnv(motion="walk", robot="humanoid3d", speed=0.5, device="cpu")
    assert te.speed == je.speed == 0.5
    assert te.mocap_data_len == je.mocap_data_len
    np.testing.assert_allclose(te.mocap_qpos.numpy(),
                               np.asarray(je.mocap_qpos), rtol=0, atol=0)
    np.testing.assert_allclose(te.mocap_qvel.numpy(),
                               np.asarray(je.mocap_qvel), rtol=0, atol=0)


def _small_ppo(env, **kw):
    cfg = dict(n_envs=4, horizon=3, minibatch_size=6, epochs=2,
               net_arch=(16,), total_timesteps=48)
    cfg.update(kw)
    return PPO(env, PPOConfig(**cfg))


def test_checkpoint_resume_equals_continue(h3d_envs, tmp_path):
    """Save after one iteration; the next iteration from the restored
    state equals the one continued without the round trip."""
    env = h3d_envs[1]
    ppo = _small_ppo(env, target_kl=0.5, adaptive_lr_kl=True,
                     lr_final_frac=0.5)
    ts = ppo.init(seed=5)
    ts, _ = ppo.train_iter(ts)
    path = checkpoint.save(str(tmp_path / "ckpt" / "state.pt"), ts)
    ts, cont = ppo.train_iter(ts)
    back = checkpoint.restore(path, ppo.init(seed=9))
    assert back.global_step == 12 and back.opt.count == ts.opt.count // 2
    back, res = ppo.train_iter(back)
    for f in cont._fields:
        a, b = getattr(cont, f), getattr(res, f)
        if a is None:
            assert b is None, f
        else:
            assert float(a) == float(b), f
    for (k, a), b in zip(ts.net.state_dict().items(),
                         back.net.state_dict().values()):
        assert torch.equal(a, b), k
    for x, y in zip(ts.env_states, back.env_states):
        assert torch.equal(x, y)
    assert back.global_step == ts.global_step == 24
    assert back.lr_scale == ts.lr_scale
    assert back.opt.count == ts.opt.count


def test_params_artifacts_and_adapt(h3d_envs, tmp_path):
    env = h3d_envs[1]
    ppo = _small_ppo(env)
    net = ppo.make_net(torch.Generator().manual_seed(1))
    p = checkpoint.save_params(str(tmp_path / "p.pt"), net)
    sd = checkpoint.restore_params(p, net.state_dict())
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v), k
    npz = checkpoint.save_actor_npz(str(tmp_path / "actor.npz"), net)
    actor = actor_from_npz(npz, device="cpu")
    obs = torch.randn(3, env.obs_size, generator=torch.Generator()
                      .manual_seed(2))
    with torch.no_grad():
        assert torch.equal(actor(obs)[0], net(obs)[0])
    # a wider obs input: zero input columns keep the mapping
    wide = networks.ActorCritic(env.obs_size + 5, env.action_size,
                                net_arch=(16,), device="cpu")
    out = checkpoint.adapt_params(net.state_dict(), wide.state_dict())
    assert out["actor.0.weight"].shape == (16, env.obs_size + 5)
    assert (out["actor.0.weight"][:, env.obs_size:] == 0).all()
    wide.load_state_dict(out)
    with torch.no_grad():
        got = wide(torch.cat([obs, torch.randn(3, 5)], 1))
        want = net(obs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w)
    bad = dict(out)
    bad.pop("log_std")
    with pytest.raises(ValueError):
        checkpoint.adapt_params(bad, wide.state_dict())


def test_eval_rollout_is_deterministic_and_stops_at_done(h3d_envs):
    env = h3d_envs[1]
    ppo = _small_ppo(env)
    net = ppo.make_net(torch.Generator().manual_seed(3))
    a = eval_rollout(ppo, net, max_steps=40, idx_init=5)
    b = eval_rollout(ppo, net, max_steps=40, idx_init=5)
    assert a["ep_len"] == b["ep_len"] <= 40
    np.testing.assert_array_equal(a["reward"], b["reward"])
    assert a["reward"].shape == (a["ep_len"],)
    assert a["ep_rew"] == pytest.approx(float(a["reward"].sum()))
    if a["ep_len"] < 40:
        assert a["done_reason"][-1] != 0


def test_cli_trains_on_cpu(tmp_path):
    ts = main(["smoke", "--env", "deep_mimic_mujoco", "--motion", "walk",
               "--robot", "humanoid3d", "--n-envs", "4", "--horizon", "4",
               "--minibatch", "8", "--epochs", "1", "--total", "32",
               "--no-wandb", "--no-render", "--device", "cpu",
               "--out", str(tmp_path)])
    assert ts.global_step == 32
    logs = glob.glob(str(tmp_path / "*_metrics.jsonl"))
    rows = [json.loads(line) for line in open(logs[0])]
    assert rows[0]["config"]["epochs"] == 1
    assert rows[0]["config"]["n_envs"] == 4
    iters = [r for r in rows if "pg_loss" in r]
    assert [r["global_step"] for r in iters] == [16, 32]
    assert all(np.isfinite(r["pg_loss"]) for r in iters)
    assert any("eval_episode_reward" in r for r in rows)
    assert glob.glob(str(tmp_path / "test*.pt"))
    assert glob.glob(str(tmp_path / "*_videos" / "*_best.pt"))


def test_cli_raises_failed_evals(tmp_path, monkeypatch):
    """A failed evaluation does not stop training: the run ends and
    saves its checkpoint, then ``main`` raises the eval's error."""
    def broken(*a, **k):
        raise ValueError("eval broke")

    monkeypatch.setattr(rl_eval, "eval_dashboard_rollout", broken)
    with pytest.raises(RuntimeError, match="eval broke"):
        main(["smoke", "--env", "deep_mimic_mujoco", "--motion", "walk",
              "--robot", "humanoid3d", "--n-envs", "4", "--horizon", "4",
              "--minibatch", "8", "--epochs", "1", "--total", "32",
              "--no-wandb", "--no-render", "--device", "cpu",
              "--out", str(tmp_path)])
    assert glob.glob(str(tmp_path / "test*.pt"))


def test_cli_guards(tmp_path, monkeypatch):
    import importlib.util

    with pytest.raises(ValueError, match="reason"):
        parse_reason([])
    assert parse_reason(["--no-wandb"]).no_wandb
    assert parse_reason(["why"]).device == "cuda"
    # the default combined env, its flags and --rk4 parse with rendering
    # on (they train at a tiny size in tests/test_torch_combined_train.py)
    for extra in ([], ["--rk4"], ["--facedown-rsi", "0.1"],
                  ["--handoff-buffer", "0.2"], ["--handoff-rsi", "0.3"],
                  ["--rsi-random-pa"], ["--handoff-buffer-cap", "8"]):
        args = parse_reason(["why", "--no-wandb", *extra])
        assert args.env == "dp_combined_env" and not args.no_render
    assert parse_reason(["why", "--handoff-buffer-cap", "8"]
                        ).handoff_buffer_cap == 8
    # the default invocation renders: a tiny CPU run without --no-render
    # writes the first evaluation's dashboard video and both plots
    ts = main(["why", "--env", "deep_mimic_mujoco", "--motion", "walk",
               "--robot", "humanoid3d", "--n-envs", "4", "--horizon", "4",
               "--minibatch", "8", "--epochs", "1", "--total", "32",
               "--no-wandb", "--device", "cpu", "--out", str(tmp_path)])
    assert ts.global_step == 32
    (videos,) = glob.glob(str(tmp_path / "*_videos"))
    assert glob.glob(os.path.join(videos, "global_step_*.mp4"))
    for name in ("rew_plot.png", "len_plot.png", "log.csv"):
        assert os.path.getsize(os.path.join(videos, name)) > 0, name
    # where matplotlib is absent, it stops before training and says so
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name == "matplotlib" else find_spec(name, *a)))
    with pytest.raises(ImportError, match="matplotlib.*--no-render"):
        main(["why", "--env", "deep_mimic_mujoco", "--no-wandb",
              "--device", "cpu", "--out", str(tmp_path / "none")])
    assert not os.path.exists(tmp_path / "none")
