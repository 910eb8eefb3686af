"""Port parity: the SAC CLI (``rl/sac_train.py``) and its PPO distill.

- The CLI trains on the CPU at tiny widths through ``main`` (the
  humanoid3d walk env, two iterations, an evaluation after each): its
  metrics rows carry the JAX CLI's keys (the JAX CLI run beside it on a
  scripted env), and the best and final actors are written in the SAC
  actor npz format.
- Every flag of the JAX CLI parses to the same value in the port's.
- The distill: the JAX package's ``distill_actor_from_ppo`` runs on a
  table env (obs made with numpy from a seed) with a PPO checkpoint
  saved by the JAX package; the port collects the same states from the
  same PPO params, starts from the JAX package's initial actor and is
  handed the JAX key chain's minibatch indices. The collected obs are
  held exactly, the PPO actions to 1e-5 scaled, the step-0 BC loss to
  the JAX package's printed value (5 decimals) and the distilled actor
  to 1e-5 scaled (max|d| / max(max|ref|, 1)).
"""
import glob
import json
import os
import re
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.rl import networks as jnet
from deepmimic_mujoco_tpu.rl import sac as jsac
from deepmimic_mujoco_tpu.rl import sac_train as jtrain

from deepmimic_mujoco_tpu_torch.rl import sac as tsac
from deepmimic_mujoco_tpu_torch.rl import sac_train as ttrain
from deepmimic_mujoco_tpu_torch.rl.convert import (
    params_from_flax, sac_actor_from_npz, sac_params_from_flax,
)

OBS, ACT, NE = 6, 3, 8
HORIZON = ttrain.DISTILL_HORIZON
TOL = 1e-5

r = np.random.RandomState(0)
OBS_D = r.randn(HORIZON + 1, NE, OBS).astype(np.float32)


class Out(NamedTuple):
    obs: object
    reward: object
    done: object


class JTable:
    """A JAX env whose obs come from OBS_D at (time, env), with the env
    index drawn from the reset key; also steps without reset."""
    obs_size, action_size = OBS, ACT

    def reset(self, key, idx_init=None):
        i = jax.random.randint(key, (), 0, NE)
        return (i, jnp.int32(0)), jnp.asarray(OBS_D)[0, i]

    def step(self, state, action):
        i, t = state
        t1 = (t + 1) % (HORIZON + 1)
        return (i, t1), Out(jnp.asarray(OBS_D)[t1, i],
                            jnp.sum(action) * 0.0 + 0.5, t1 == 3)

    step_auto_reset = step


class TTable:
    """The same table for the port, its env indices handed in."""
    obs_size, action_size = OBS, ACT
    device = torch.device("cpu")

    def __init__(self, env_idx):
        self.env_idx = torch.tensor(env_idx)

    def reset(self, n, generator=None):
        return 0, torch.tensor(OBS_D[0])[self.env_idx]

    def step_auto_reset(self, t, action, generator=None):
        obs = torch.tensor(OBS_D[t + 1])[self.env_idx]
        return t + 1, Out(obs, None, None)


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1.0)


def test_distill_matches_jax(tmp_path, capsys):
    from deepmimic_mujoco_tpu.rl.checkpoint import save_params

    seed, steps, n_rollout = 0, 3, NE
    ppo_params = jnet.ActorCritic(ACT).init(jax.random.PRNGKey(5),
                                            jnp.zeros(OBS))
    ckpt = save_params(str(tmp_path / "ppo"), ppo_params)
    cfg = dict(net_arch=(16,), n_envs=NE)
    jsac_obj = jsac.SAC(JTable(), jsac.SACConfig(**cfg))
    capsys.readouterr()
    jactor = jtrain.distill_actor_from_ppo(
        jsac_obj, JTable(), ckpt, n_rollout=n_rollout, steps=steps,
        seed=seed)
    printed = capsys.readouterr().out
    loss0 = float(re.search(r"distill step 0: bc loss ([0-9.]+)",
                            printed).group(1))

    # the same states, from the same reset keys and PPO params
    keys = jax.random.split(jax.random.PRNGKey(seed), n_rollout)
    env_idx = np.asarray(jax.vmap(JTable().reset)(keys)[0][0])
    ppo = jnet.ActorCritic(ACT)
    net = tsac_ppo_net(ppo_params)
    obs_d, act_d = ttrain.collect_ppo_states(TTable(env_idx), net,
                                             n_rollout, None)
    want_obs = OBS_D[:HORIZON][:, env_idx].reshape(-1, OBS)
    np.testing.assert_array_equal(obs_d.numpy(), want_obs)
    want_act = np.asarray(ppo.apply(ppo_params, jnp.asarray(want_obs))[0])
    assert _scaled(want_act, act_d.numpy()) < TOL

    # the JAX package's initial actor and minibatch indices
    init = jsac.Actor(ACT, (16,)).init(jax.random.PRNGKey(seed + 1),
                                       jnp.zeros(OBS))
    actor = tsac.Actor(OBS, ACT, (16,), device="cpu")
    actor.load_state_dict(sac_params_from_flax(
        jax.tree.map(np.asarray, init))[0])
    key, idxs = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        idxs.append(np.asarray(jax.random.randint(
            sub, (ttrain.DISTILL_BATCH,), 0, HORIZON * n_rollout)))
    draw = lambda nb: torch.tensor(idxs.pop(0), dtype=torch.int64)
    losses = ttrain.bc_fit(actor, obs_d, act_d, steps, 3e-4, -1.0, draw)
    assert abs(float(losses[0]) - loss0) <= 5e-6
    want = sac_params_from_flax(jax.tree.map(np.asarray, jactor))[0]
    got = actor.state_dict()
    err = max(_scaled(want[k], got[k].numpy()) for k in got)
    assert err < TOL, err


def tsac_ppo_net(ppo_params):
    from deepmimic_mujoco_tpu_torch.rl.networks import ActorCritic

    net = ActorCritic(OBS, ACT, device="cpu")
    net.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                      ppo_params)))
    return net


ALL_FLAGS = ["why", "--motion", "run", "--robot", "unitree_g1",
             "--n-envs", "8", "--buffer", "100", "--batch", "4",
             "--steps-per-iter", "3", "--updates-per-iter", "5",
             "--lr", "0.002", "--arch", "32", "16", "--seed", "7",
             "--total", "99", "--out", "/nowhere", "--eval-every", "12",
             "--idx-init", "3", "--no-warm-start-lam",
             "--mesh-subcapsules", "1", "--alpha-lr", "0.01",
             "--actor-lr", "0.001", "--log-alpha-min", "-3",
             "--critic-warmup", "50", "--init-actor-from-ppo", "p.npz"]


def test_cli_parses_every_jax_flag():
    want = vars(jtrain.parse_args(ALL_FLAGS))
    got = vars(ttrain.parse_args(ALL_FLAGS))
    assert set(got) - set(want) == {"device"}
    assert {k: got[k] for k in want} == want
    assert ttrain.parse_args([]).device == "cuda"


TINY = ["tiny", "--n-envs", "4", "--buffer", "64", "--batch", "8",
        "--steps-per-iter", "2", "--updates-per-iter", "2", "--arch", "16",
        "--total", "16", "--eval-every", "8"]


def _rows(out_dir):
    path, = glob.glob(os.path.join(out_dir, "*_metrics.jsonl"))
    return [json.loads(line) for line in open(path)]


def test_cli_trains_and_logs_the_jax_keys(tmp_path, monkeypatch):
    import deepmimic_mujoco_tpu.envs as jenvs

    monkeypatch.setattr(jenvs, "DPEnv", lambda **kw: JTable())
    jtrain.main(TINY + ["--out", str(tmp_path / "jax")])
    jrows = _rows(tmp_path / "jax")

    out = tmp_path / "port"
    s = ttrain.main(TINY + ["--out", str(out), "--device", "cpu"])
    rows = _rows(out)
    assert len(rows) == len(jrows) == 3
    assert set(rows[0]["config"]) == set(jrows[0]["config"])
    for row, jrow in zip(rows[1:], jrows[1:]):
        assert set(row) == set(jrow)
        assert "eval_ep_rew" in row
        assert all(np.isfinite(v) for v in row.values())
    assert [r["global_step"] for r in rows[1:]] == [8, 16]
    assert s.global_step == 16
    best, = glob.glob(str(out / "*_best_actor.npz"))
    final, = [p for p in glob.glob(str(out / "*_actor.npz"))
              if "best" not in p]
    actor = sac_actor_from_npz(final, device="cpu")
    for k, v in s.actor.state_dict().items():
        np.testing.assert_array_equal(v.numpy(),
                                      actor.state_dict()[k].numpy())
    assert sac_actor_from_npz(best, device="cpu").mean.out_features == 28
    assert max(r.get("eval_ep_rew", -1) for r in rows) > 0


def test_eval_episode_freezes_after_done():
    """The evaluation sums the reward up to and including the done step,
    as the JAX CLI's frozen scan does; a done env adds nothing after."""
    from deepmimic_mujoco_tpu_torch.envs import DPEnv

    env = DPEnv(motion="walk", robot="humanoid3d", device="cpu")
    actor = tsac.Actor(env.obs_size, env.action_size, (16,), device="cpu",
                       generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        actor.mean.bias.fill_(3.0)     # saturated torques: a fast fall
    total = ttrain.eval_episode(env, actor, 20, max_steps=1000)
    state, obs = env.reset(1, idx_init=20)
    want, n = 0.0, 0
    with torch.no_grad():
        while True:
            state, out = env.step(state, torch.tanh(actor(obs)[0]))
            want += float(out.reward[0])
            n += 1
            if bool(out.done[0]):
                break
            obs = out.obs
    assert n < 1000
    assert total == pytest.approx(want, rel=1e-6)
