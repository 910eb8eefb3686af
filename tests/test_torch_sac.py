"""Port parity: SAC iterations of the torch port against the JAX
package's ``SAC._train_iter_impl``, the SAC networks, and the SAC gate
actor's data file.

A scripted env, written here for both frameworks, returns a fixed table
of obs, rewards and dones (made with numpy from a seed), whatever the
actions, so both trainers fill their replay buffers from the same
rollout. JAX's draws come from its key chain (``key, ak = split(key)``
per collect step, ``key, ks, kn, kp = split(key, 4)`` per update) and
are handed to the port through ``SAC.draw_action_noise``/``draw_idx``/
``draw_next_noise``/``draw_pi_noise``; the port starts from the JAX
package's initial params.

Held after each of two iterations (the buffer of 24 rows wraps in the
second): the buffer's obs, reward, next_obs and done, ``buf_pos`` and
``buf_full`` exactly, its actions (tanh of each framework's own actor
forward, whose params are held to 1e-5) to 1e-5 scaled; the critic and
actor loss means and alpha to 1e-5 relative; the actor, critic, target
critic and log_alpha to 1e-5 scaled (max|d| / max(max|ref|, 1)); the
episode statistics to 1e-5 relative. One exception: in the
critic-warmup case the actor after iteration 2 is held to 2e-5 scaled.
Its first three Adam steps after the release each move a parameter by
about 0.58 lr whatever the gradient's size, and the log-std head's
gradient passes through log(1 - a^2 + 1e-6), which magnifies the two
frameworks' tanh rounding where |a| nears 1: measured 1.17e-5 on one
log-std weight, every other entry within 1.2e-7.
The networks' forwards from flax params are held to 1e-5,
``squash_sample``'s action to 1e-6 and its log-probability to 1e-5
scaled on given noise (the same log magnifies the tanh rounding of
saturated actions: measured 4.3e-6 with |z| up to 5), and the gate
actor file to the orbax checkpoint it was exported from to 1e-6.
"""
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.rl import sac as jsac

from deepmimic_mujoco_tpu_torch.rl import sac as tsac
from deepmimic_mujoco_tpu_torch.rl.convert import (
    sac_actor_from_npz, sac_params_from_flax,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, OBS, ACT = 4, 4, 6, 3
ITERS = 2
ARCH = (16,)
BUF, BATCH, UPDATES = 24, 8, 3
TOL_ACTION = 1e-5
TOL_LOSS = 1e-5
TOL_PARAM = 1e-5
TOL_NET = 1e-5
TOL_WARMUP_ACTOR = 2e-5
TOL_SQUASH = 1e-6
TOL_SQUASH_LOGP = 1e-5

r = np.random.RandomState(0)
OBS_T = r.randn(ITERS * H + 1, N, OBS).astype(np.float32)
REW = r.uniform(0, 1, (ITERS * H, N)).astype(np.float32)
DONE = r.rand(ITERS * H, N) < 0.25


class Out(NamedTuple):
    obs: object
    reward: object
    done: object


class JScripted:
    """The table env for the JAX trainer: state (env index, time)."""
    obs_size, action_size = OBS, ACT

    def reset(self, key):
        return (jnp.int32(0), jnp.int32(0)), jnp.zeros(OBS, jnp.float32)

    def step_auto_reset(self, state, action):
        i, t = state
        return (i, t + 1), Out(jnp.asarray(OBS_T)[t + 1, i],
                               jnp.asarray(REW)[t, i],
                               jnp.asarray(DONE)[t, i])


class TScripted:
    """The same table env for the port: state is the time index."""
    obs_size, action_size = OBS, ACT
    device = torch.device("cpu")

    def reset(self, n_envs, generator=None):
        return 0, torch.tensor(OBS_T[0])

    def step_auto_reset(self, t, action, generator=None):
        return t + 1, Out(torch.tensor(OBS_T[t + 1]), torch.tensor(REW[t]),
                          torch.tensor(DONE[t]))


class Forced(tsac.SAC):
    """The port's trainer fed the JAX package's draws."""

    def __init__(self, env, cfg, draws):
        super().__init__(env, cfg)
        self.draws = {k: list(v) for k, v in draws.items()}

    def _pop(self, name):
        return torch.tensor(self.draws[name].pop(0))

    def draw_action_noise(self, s, mean):
        return self._pop("act")

    def draw_idx(self, s, valid):
        want, idx = self.draws["idx"].pop(0)
        assert valid == want
        return torch.tensor(idx, dtype=torch.int64)

    def draw_next_noise(self, s, mean):
        return self._pop("next")

    def draw_pi_noise(self, s, mean):
        return self._pop("pi")


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1.0)


def _rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(a), 1e-8)


def _sd_err(want_sd, module):
    got = module.state_dict()
    assert set(want_sd) == set(got)
    return max(_scaled(want_sd[k], got[k].detach().numpy()) for k in got)


def jax_draws(key, valids):
    """The draws of ITERS iterations from the JAX key chain."""
    draws = {"act": [], "idx": [], "next": [], "pi": []}
    for valid in valids:
        for _ in range(H):
            key, ak = jax.random.split(key)
            draws["act"].append(np.asarray(jax.random.normal(ak, (N, ACT))))
        for _ in range(UPDATES):
            key, ks, kn, kp = jax.random.split(key, 4)
            draws["idx"].append((valid, np.asarray(jax.random.randint(
                ks, (BATCH,), 0, valid))))
            draws["next"].append(np.asarray(
                jax.random.normal(kn, (BATCH, ACT))))
            draws["pi"].append(np.asarray(
                jax.random.normal(kp, (BATCH, ACT))))
    return draws


CASES = {
    "defaults": dict(),
    # the actor is frozen in iteration 1 only (global_step 0 < 16), with
    # Adam's count and moments still advancing
    "critic_warmup": dict(critic_warmup_steps=N * H),
    "actor_lr": dict(actor_lr=3e-3),
    # a large alpha lr drives log_alpha onto its floor
    "alpha_floor": dict(alpha_lr=0.5, log_alpha_min=-0.05),
    "action_scale": dict(action_scale=0.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sac_iterations_match_jax(case):
    kw = dict(n_envs=N, buffer_size=BUF, batch_size=BATCH, steps_per_iter=H,
              updates_per_iter=UPDATES, net_arch=ARCH, lr=1e-2,
              total_timesteps=ITERS * N * H)
    kw.update(CASES[case])
    jtrainer = jsac.SAC(JScripted(), jsac.SACConfig(**kw))
    js = jtrainer.init(seed=3)
    js = js._replace(env_states=(jnp.arange(N, dtype=jnp.int32),
                                 jnp.zeros(N, jnp.int32)),
                     last_obs=jnp.asarray(OBS_T[0]))
    # iteration 1 fills rows 0..15 (valid 16); iteration 2 wraps to 8
    tp = Forced(TScripted(), tsac.SACConfig(**kw),
                jax_draws(js.key, (N * H, BUF)))
    s = tp.init(seed=0)
    actor_sd, critic_sd = sac_params_from_flax(
        jax.tree.map(np.asarray, js.actor),
        jax.tree.map(np.asarray, js.critic))
    s.actor.load_state_dict(actor_sd)
    s.critic.load_state_dict(critic_sd)
    s.target_critic.load_state_dict(critic_sd)
    assert s.target_critic.critics[0].layers[0].weight.data_ptr() != \
        s.critic.critics[0].layers[0].weight.data_ptr()

    for it in range(ITERS):
        js, jst = jtrainer._train_iter(js)
        s, st = tp.train_iter(s)
        jbuf = jax.tree.map(np.asarray, js.buffer)
        for k in ("obs", "reward", "next_obs", "done"):
            np.testing.assert_array_equal(jbuf[k], s.buffer[k].numpy(),
                                          err_msg=f"{case} it {it} {k}")
        assert _scaled(jbuf["action"], s.buffer["action"].numpy()) \
            < TOL_ACTION
        assert int(js.buf_pos) == s.buf_pos == ((it + 1) * N * H) % BUF
        assert bool(js.buf_full) == s.buf_full == (it == 1)
        assert int(js.global_step) == s.global_step == (it + 1) * N * H

        errs = {k: _rel(j, getattr(st, k)) for k, j in zip(st._fields, jst)}
        bad = {k: v for k, v in errs.items() if not v < TOL_LOSS}
        assert not bad, (case, it, bad)
        jact, jcrit = sac_params_from_flax(
            jax.tree.map(np.asarray, js.actor),
            jax.tree.map(np.asarray, js.critic))
        jtgt = sac_params_from_flax(
            critic_params=jax.tree.map(np.asarray, js.target_critic))[1]
        perr = {"actor": _sd_err(jact, s.actor),
                "critic": _sd_err(jcrit, s.critic),
                "target": _sd_err(jtgt, s.target_critic),
                "log_alpha": _scaled(js.log_alpha,
                                     s.log_alpha.detach().numpy())}
        tol = {"actor": TOL_WARMUP_ACTOR} if case == "critic_warmup" \
            and it == 1 else {}
        assert all(v < tol.get(k, TOL_PARAM) for k, v in perr.items()), \
            (case, it, perr)

        if case == "critic_warmup" and it == 0:
            assert _sd_err(actor_sd, s.actor) == 0.0
            assert s.opt_actor.count == UPDATES
        if case == "alpha_floor":
            assert float(s.log_alpha.detach()) == pytest.approx(-0.05,
                                                                abs=1e-7)
    # the target moved by Polyak steps, and only by them
    assert _sd_err(critic_sd, s.target_critic) > 0
    assert float(st.ep_count) > 0


def test_networks_match_flax():
    obs = np.random.RandomState(1).randn(8, OBS).astype(np.float32)
    act = np.random.RandomState(2).uniform(-1, 1, (8, ACT)).astype(
        np.float32)
    jactor = jsac.Actor(ACT, (32, 16))
    jcritic = jsac.DoubleCritic((32, 16))
    pa = jactor.init(jax.random.PRNGKey(0), jnp.zeros(OBS))
    pc = jcritic.init(jax.random.PRNGKey(1), jnp.zeros(OBS), jnp.zeros(ACT))
    asd, csd = sac_params_from_flax(jax.tree.map(np.asarray, pa),
                                    jax.tree.map(np.asarray, pc))
    actor = tsac.Actor(OBS, ACT, (32, 16), device="cpu")
    critic = tsac.DoubleCritic(OBS, ACT, (32, 16), device="cpu")
    actor.load_state_dict(asd)
    critic.load_state_dict(csd)
    # push the log-std head against both clamps
    big = jax.tree.map(np.asarray, pa)
    big["params"]["Dense_3"]["bias"] = np.linspace(-40, 40, ACT).astype(
        np.float32)
    actor_big = tsac.Actor(OBS, ACT, (32, 16), device="cpu")
    actor_big.load_state_dict(sac_params_from_flax(big)[0])
    with torch.no_grad():
        t_obs, t_act = torch.tensor(obs), torch.tensor(act)
        for jp, net in ((pa, actor), (big, actor_big)):
            want = jactor.apply(jp, jnp.asarray(obs))
            got = net(t_obs)
            for a, b in zip(want, got):
                assert _scaled(a, b.numpy()) < TOL_NET
        want = jcritic.apply(pc, jnp.asarray(obs), jnp.asarray(act))
        got = critic(t_obs, t_act)
        for a, b in zip(want, got):
            assert _scaled(a, b.numpy()) < TOL_NET
        assert float(actor_big(t_obs)[1].max()) == 2.0
        assert float(actor_big(t_obs)[1].min()) == -20.0


def test_squash_sample_matches_jax():
    r = np.random.RandomState(4)
    mean = r.randn(16, ACT).astype(np.float32)
    log_std = r.uniform(-3, 1, (16, ACT)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ja, jlogp = jsac._squash_sample(key, jnp.asarray(mean),
                                    jnp.asarray(log_std))
    noise = np.asarray(jax.random.normal(key, mean.shape))
    ta, tlogp = tsac.squash_sample(torch.tensor(mean), torch.tensor(log_std),
                                   torch.tensor(noise))
    assert _scaled(ja, ta.numpy()) < TOL_SQUASH
    assert _scaled(jlogp, tlogp.numpy()) < TOL_SQUASH_LOGP


def test_dense_init_matches_flax_distribution():
    """The port's Linear layers start as flax's Dense: a zero bias and a
    kernel with std sqrt(1/fan_in), truncated at 2 std of the
    underlying normal."""
    actor = tsac.Actor(256, 8, (512,), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    w = actor.trunk[0].weight.detach().numpy()
    std = np.sqrt(1 / 256)
    assert abs(w.std() / std - 1) < 0.02
    assert np.abs(w).max() <= 2 * std / .87962566103423978 + 1e-7
    assert not actor.trunk[0].bias.detach().numpy().any()
    jw = np.asarray(jsac.Actor(8, (512,)).init(
        jax.random.PRNGKey(0), jnp.zeros(256))["params"]["Dense_0"]["kernel"])
    assert abs(jw.std() / w.std() - 1) < 0.02
    assert abs(np.abs(jw).max() / np.abs(w).max() - 1) < 0.02


def test_sac_gate_actor_npz_matches_orbax():
    """Provenance of data/sac_walk_gate_actor.npz: the committed orbax
    checkpoint runs/sac_walk_best_actor, restored as the JAX gate test
    restores it, gives the same arrays and the same actions."""
    from deepmimic_mujoco_tpu.rl.checkpoint import restore_params

    jactor = jsac.Actor(28, (1024, 512))
    tmpl = jactor.init(jax.random.PRNGKey(0), jnp.zeros(67))
    params = restore_params(os.path.join(_REPO, "runs/sac_walk_best_actor"),
                            tmpl)
    actor = sac_actor_from_npz(os.path.join(
        _REPO, "deepmimic_mujoco_tpu_torch/data/sac_walk_gate_actor.npz"),
        device="cpu")
    want = sac_params_from_flax(jax.tree.map(np.asarray, params))[0]
    assert _sd_err(want, actor) < 1e-6
    obs = np.random.RandomState(3).randn(8, 67).astype(np.float32)
    with torch.no_grad():
        got = actor(torch.tensor(obs))
    for a, b in zip(jactor.apply(params, jnp.asarray(obs)), got):
        assert _scaled(a, b.numpy()) < TOL_NET


def test_real_env_sac_iteration():
    """One iteration on the humanoid3d walk env at n_envs 4 on the CPU
    (the JAX package's test_sac_single_iteration): the step count, the
    buffer rows it wrote (each row's next_obs is the next row's obs, as
    the collect loop carries the terminal obs on), finite losses and an
    alpha inside its bounds."""
    from deepmimic_mujoco_tpu_torch.envs import DPEnv

    env = DPEnv(motion="walk", robot="humanoid3d", iterations=8,
                device="cpu")
    cfg = tsac.SACConfig(n_envs=4, buffer_size=512, batch_size=16,
                         steps_per_iter=4, updates_per_iter=2, net_arch=(16,))
    trainer = tsac.SAC(env, cfg)
    s = trainer.init(seed=0)
    s, st = trainer.train_iter(s)
    assert s.global_step == 16 and s.buf_pos == 16 and not s.buf_full
    buf = s.buffer
    assert buf["obs"].shape == (512, env.obs_size)
    np.testing.assert_array_equal(buf["next_obs"][:12].numpy(),
                                  buf["obs"][4:16].numpy())
    assert not buf["obs"][16:].any()
    assert float(buf["action"][:16].abs().max()) <= 1.0
    assert all(np.isfinite(float(x)) for x in st)
    assert np.exp(cfg.log_alpha_min) <= float(st.alpha) <= np.exp(2.0)
    assert tsac.buffer_bytes(buf) == 512 * (2 * env.obs_size
                                            + env.action_size + 2) * 4
