"""Params directories of the JAX package carried into the port:
``tools/export_params.py`` (a JAX-side script) against flax.

Held:
- the port's forward from an exported file equals flax's
  ``ActorCritic.apply`` / ``PDTargetActorCritic.apply`` on 8 seeded
  observations within 1e-6 (mean, value and log_std, each scaled by
  max(|ref|, 1)), both evaluated in float64 from the same float32
  weights: ``runs/combined_r5_best``, the G1 walk gate directory and a
  PD net that the JAX package initialises and saves here; the PD net's
  env action too. In float32 the two frameworks' forwards part by up to
  1.3e-6 scaled in the value (accumulation order alone: each is as far
  from the float64 forward), so float32 is held at 1e-5;
- the committed warm starts of the recorded recipes are the exports of
  their directories, bit for bit;
- the adapt path: a G1 walk (``DPEnv``) export into a combined-env
  template, the port's ``adapt_params`` against ``params_from_flax`` of
  the JAX package's, exactly;
- the training CLI warm-started from an export with ``--reset-log-std``
  (the F2 recipe's engine options, tiny widths): its first rollout step's
  action mean equals the JAX net's on the same obs within 1e-6;
- ``tools/play_combined`` plays an export as it plays the actor npz of
  the same checkpoint.
"""
import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.rl import networks as jnetworks
from deepmimic_mujoco_tpu.rl.checkpoint import adapt_params as jadapt
from deepmimic_mujoco_tpu.rl.checkpoint import restore_params as jrestore

from deepmimic_mujoco_tpu_torch.rl import checkpoint, networks
from deepmimic_mujoco_tpu_torch.rl.convert import params_from_flax

TOL = 1e-6
TOL_F32 = 1e-5       # float32 accumulation order (see the docstring)
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(_REPO, "deepmimic_mujoco_tpu_torch", "data")
COMBINED_R5 = os.path.join(_REPO, "runs", "combined_r5_best")
G1_WALK = os.path.join(_REPO, "runs", "walk_test20260817-1741_21_videos",
                       "walk_test20260817-1741_21_best")
# the widths of the combined env and of a G1 DPEnv (obs, action)
COMBINED_WIDTHS, G1_WIDTHS = (98, 23), (85, 23)


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_params", os.path.join(_REPO, "tools", "export_params.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def exporter():
    return _exporter()


def _widths(obs, act):
    """What a torque template needs of an env: its widths."""
    return SimpleNamespace(obs_size=obs, action_size=act)


def _obs(n, width, seed=0):
    return np.random.RandomState(seed).randn(n, width).astype(np.float32)


def _scaled(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1.0))


def _forward_errs(jnet, params, net, obs):
    """Scaled errors of (mean, log_std, value) in float64, and with a
    ``_f32`` suffix in float32."""
    errs = {}
    for suffix, dtype, jdtype in (("", torch.float64, jnp.float64),
                                  ("_f32", torch.float32, jnp.float32)):
        with jax.enable_x64(dtype == torch.float64):
            p = jax.tree.map(lambda x: jnp.asarray(x, jdtype), params)
            want = jnet.apply(p, jnp.asarray(obs, jdtype))
            want = [np.asarray(x) for x in want]
        with torch.no_grad():
            got = net.to(dtype)(torch.as_tensor(obs, dtype=dtype))
        net.float()
        for name, w, g in zip(("mean", "log_std", "value"), want, got):
            errs[name + suffix] = _scaled(w, g.numpy())
    return errs


def _assert_forward(errs):
    bad = {k: e for k, e in errs.items()
           if not e < (TOL_F32 if k.endswith("_f32") else TOL)}
    assert not bad, errs


@pytest.mark.parametrize("src,widths", [(COMBINED_R5, COMBINED_WIDTHS),
                                        (G1_WALK, G1_WIDTHS)],
                         ids=["combined_r5_best", "g1_walk_gate"])
def test_export_reproduces_flax_forward(exporter, tmp_path, src, widths):
    out = str(tmp_path / "params.pt")
    exporter.export(src, out, _widths(*widths))
    jnet = jnetworks.ActorCritic(widths[1])
    params = jrestore(src)
    net = networks.ActorCritic(*widths, device="cpu")
    net.load_state_dict(checkpoint.restore_params(out))
    _assert_forward(_forward_errs(jnet, params, net, _obs(8, widths[0])))


def test_export_of_a_pd_net_reproduces_flax_forward(exporter, tmp_path):
    """A PD net the JAX package initialises and saves: the same
    parameters as a torque net, and the port's PD head (its gains from
    the port's env) gives flax's env action."""
    from deepmimic_mujoco_tpu.envs import DPEnv as JDPEnv
    from deepmimic_mujoco_tpu.rl.checkpoint import save_params as jsave

    from deepmimic_mujoco_tpu_torch.envs import DPEnv

    jenv = JDPEnv(motion="walk", robot="humanoid3d")
    jnet = jnetworks.make_policy("pd", jenv, net_arch=(64, 32),
                                 init_log_std=-0.5)
    params = jnet.init(jax.random.PRNGKey(7), jnp.zeros(jenv.obs_size))
    # the initial head is near zero: move every leaf so it is held
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(8), len(leaves))
    params = jax.tree.unflatten(tree, [
        x + 0.1 * jax.random.normal(k, x.shape) for x, k in zip(leaves,
                                                                 keys)])
    src = jsave(str(tmp_path / "pd_best"), params)
    out = str(tmp_path / "pd_params.pt")
    exporter.main([src, out, "--env", "deep_mimic_mujoco", "--motion",
                   "walk", "--robot", "humanoid3d", "--kind", "pd",
                   "--net-arch", "64,32"])
    env = DPEnv(motion="walk", robot="humanoid3d", device="cpu")
    net = networks.make_policy("pd", env, net_arch=(64, 32), device="cpu")
    assert isinstance(net, networks.PDTargetActorCritic)
    net.load_state_dict(checkpoint.restore_params(out))
    obs = _obs(8, env.obs_size, seed=1)
    errs = _forward_errs(jnet, params, net, obs)
    a = _obs(8, env.action_size, seed=2)
    want = jnet.apply(params, jnp.asarray(obs), jnp.asarray(a),
                      method=jnet.env_action)
    got = net.env_action(torch.as_tensor(obs), torch.as_tensor(a))
    errs["env_action_f32"] = _scaled(want, got.numpy())
    _assert_forward(errs)
    assert errs["env_action_f32"] < TOL, errs


@pytest.mark.parametrize("name", ["combined_r4_best", "g1_walk_best"])
def test_committed_warm_starts_are_the_exports(exporter, tmp_path, name):
    src, _, env, _, _, kind = [row for row in exporter.ALL
                               if row[1] == f"{name}_params.pt"][0]
    committed = checkpoint.restore_params(
        os.path.join(DATA, f"{name}_params.pt"))
    widths = COMBINED_WIDTHS if env == "dp_combined_env" else G1_WIDTHS
    assert committed["actor.0.weight"].shape[1] == widths[0]
    out = str(tmp_path / "fresh.pt")
    exporter.export(os.path.join(_REPO, src), out, _widths(*widths), kind)
    fresh = checkpoint.restore_params(out)
    assert sorted(fresh) == sorted(committed)
    for k, v in fresh.items():
        assert torch.equal(v, committed[k]), k


def test_adapt_of_an_export_equals_the_jax_adapt(exporter, tmp_path):
    out = str(tmp_path / "walk.pt")
    exporter.export(G1_WALK, out, _widths(*G1_WIDTHS))
    obs_w, act = COMBINED_WIDTHS
    template = networks.ActorCritic(obs_w, act, device="cpu").state_dict()
    got = checkpoint.adapt_params(checkpoint.restore_params(out), template)
    jtmpl = jnetworks.ActorCritic(act).init(jax.random.PRNGKey(0),
                                            jnp.zeros(obs_w))
    want = params_from_flax(jax.tree.map(
        np.asarray, jadapt(jrestore(G1_WALK), jtmpl)))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(v, got[k]), k
    assert got["actor.0.weight"].shape == (256, obs_w)


def test_cli_warm_start_from_an_export(tmp_path, monkeypatch):
    """The F2 recipe's warm start (``tools/train_queue_r5c.sh``: G1 run
    from the G1 walk export, no warm start of the solve, one subcapsule)
    at 4 envs x 4 steps: before the first update the net is the file's
    with log_std reset, and its action mean on the first step's obs is
    the JAX net's."""
    from deepmimic_mujoco_tpu_torch.rl import ppo as tppo
    from deepmimic_mujoco_tpu_torch.rl import train

    path = os.path.join(DATA, "g1_walk_best_params.pt")
    seen = []
    rollout = tppo.PPO.rollout

    def first_step(self, ts):
        if not seen:
            with torch.no_grad():
                mean, log_std, _ = ts.net(ts.last_obs)
            seen.append((self.env, ts.last_obs.clone(), mean, log_std,
                         {k: v.clone() for k, v in
                          ts.net.state_dict().items()}))
        return rollout(self, ts)

    monkeypatch.setattr(tppo.PPO, "rollout", first_step)
    train.main(["cli export", "--env", "deep_mimic_mujoco", "--motion",
                "run", "--robot", "unitree_g1", "--no-warm-start-lam",
                "--mesh-subcapsules", "1", "--init-params", path,
                "--reset-log-std", "-0.7", "--n-envs", "4", "--horizon",
                "4", "--minibatch", "8", "--epochs", "1", "--total", "16",
                "--no-wandb", "--no-render", "--device", "cpu", "--out",
                str(tmp_path)])
    from deepmimic_mujoco_tpu_torch.physics.collision import (
        build_pair_tables,
    )

    env, obs, mean, log_std, sd = seen[0]
    assert not env.engine.warm_start_lam
    assert [len(g.g1) for g in env.engine.tables] == [
        len(g.g1) for g in build_pair_tables(env.model, 1)]
    want = checkpoint.restore_params(path)
    for k, v in want.items():
        if k != "log_std":
            assert torch.equal(v, sd[k]), k
    assert torch.equal(sd["log_std"], torch.full((23,), -0.7))
    assert torch.equal(log_std, torch.full((23,), -0.7))
    jm, _, _ = jnetworks.ActorCritic(23).apply(jrestore(G1_WALK),
                                               jnp.asarray(obs.numpy()))
    assert _scaled(jm, mean.numpy()) < TOL


def test_play_combined_plays_an_export_as_its_actor_npz(exporter, tmp_path):
    """The port's params file of ``runs/combined_r5_best`` and the actor
    npz committed from it drive the same episode."""
    from deepmimic_mujoco_tpu_torch.tools import play_combined

    out = str(tmp_path / "combined_r5_best.pt")
    exporter.export(COMBINED_R5, out, _widths(*COMBINED_WIDTHS))
    argv = ["--steps", "12", "--warmstart", "4", "--device", "cpu"]
    npz = os.path.join(DATA, "combined_r5_best_actor.npz")
    want = play_combined.main(["--checkpoint", npz, *argv])
    got = play_combined.main(["--checkpoint", out, *argv])
    assert np.isfinite(got[0]) and got == want
