"""Port parity: one PPO iteration of the torch port against the JAX
package's ``PPO._train_iter_impl`` on a fixed batch, with forced draws.

A scripted env, written here for both frameworks, returns a fixed table
of obs, rewards, dones and velocity matches (made with numpy from a
seed), whatever the actions, so both trainers see the same rollout.
JAX's draws come from its key chain (``key, akey = split(key)`` per
rollout step, ``key, pkey = split(key)`` per epoch) and are handed to
the port through ``PPO.draw_noise``/``draw_perm``; the port starts from
the JAX package's initial params. The JAX optimizer is chained after an
identity transformation that keeps the first minibatch's raw gradients
in its state, so they can be read back; the JAX package is not changed.

Held: GAE advantages and returns against the reference recursion on the
JAX values (1e-6 scaled); the five losses, the KL and the clip fraction
(1e-5 relative); the first minibatch's gradients (1e-4 scaled); the
params after each of two iterations (1e-5 scaled). The cases cover the
KL guard tripping, the adaptive lr-by-KL controller, the linear lr
decay, value clipping and the alive/velocity shaping with its anneal.
"""
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deepmimic_mujoco_tpu.rl import networks as jnet
from deepmimic_mujoco_tpu.rl.ppo import PPO as JPPO
from deepmimic_mujoco_tpu.rl.ppo import PPOConfig as JConfig

from deepmimic_mujoco_tpu_torch.rl import ppo as tppo
from deepmimic_mujoco_tpu_torch.rl.convert import params_from_flax

N, H, OBS, ACT = 4, 4, 6, 3
ITERS = 2
ARCH = (16,)
B = N * H
TOL_GAE = 1e-6
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4
TOL_PARAM = 1e-5

r = np.random.RandomState(0)
OBS_T = r.randn(ITERS * H + 1, N, OBS).astype(np.float32)
REW = r.uniform(0, 1, (ITERS * H, N)).astype(np.float32)
DONE = r.rand(ITERS * H, N) < 0.2
VM = r.uniform(0, 1, (ITERS * H, N)).astype(np.float32)


class Out(NamedTuple):
    obs: object
    reward: object
    done: object
    vel_match: object


class JScripted:
    """The table env for the JAX trainer: state (env index, time)."""
    obs_size, action_size = OBS, ACT

    def reset(self, key):
        return (jnp.int32(0), jnp.int32(0)), jnp.zeros(OBS, jnp.float32)

    def step_auto_reset(self, state, action):
        i, t = state
        return (i, t + 1), Out(jnp.asarray(OBS_T)[t + 1, i],
                               jnp.asarray(REW)[t, i],
                               jnp.asarray(DONE)[t, i],
                               jnp.asarray(VM)[t, i])


class TOut(NamedTuple):
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    vel_match: torch.Tensor
    contact_overflow: torch.Tensor


class TScripted:
    """The same table env for the port: state is the time index."""
    obs_size, action_size = OBS, ACT
    device = torch.device("cpu")

    def reset(self, n_envs, generator=None):
        return 0, torch.tensor(OBS_T[0])

    def step_auto_reset(self, t, action, generator=None):
        return t + 1, TOut(torch.tensor(OBS_T[t + 1]), torch.tensor(REW[t]),
                           torch.tensor(DONE[t]), torch.tensor(VM[t]),
                           torch.zeros(N, dtype=torch.int64))


class Forced(tppo.PPO):
    """The port's trainer fed the JAX package's draws."""

    def __init__(self, env, cfg, noises, perms):
        super().__init__(env, cfg)
        self.noises, self.perms = list(noises), list(perms)
        self.batches = []

    def draw_noise(self, ts, mean):
        return torch.tensor(self.noises.pop(0))

    def draw_perm(self, ts, n):
        return torch.tensor(self.perms.pop(0), dtype=torch.int64)

    def update(self, ts, batch):
        self.batches.append([x.clone() for x in batch])
        return super().update(ts, batch)


def _capture_first_grads():
    """Identity transformation whose state keeps the first update's
    incoming (raw) gradients."""
    def init(params):
        return (jnp.zeros((), jnp.int32),
                jax.tree.map(jnp.zeros_like, params))

    def update(updates, state, params=None):
        n, g0 = state
        g0 = jax.tree.map(lambda u, g: jnp.where(n == 0, u, g), updates, g0)
        return updates, (n + 1, g0)
    return optax.GradientTransformation(init, update)


def params_to_flax(named) -> dict:
    """The inverse of ``params_from_flax``: a mapping of the port's
    parameter names to tensors (a state dict, or the gradients of one)
    as a flax ``ActorCritic`` tree of numpy arrays."""
    nl = sum(1 for k in named if k.startswith("actor.")
             and k.endswith(".weight"))
    np_ = lambda t: t.detach().cpu().numpy()
    p = {}
    for i in range(2 * nl):
        head = "actor" if i < nl else "critic"
        p[f"Dense_{i}"] = {
            "kernel": np_(named[f"{head}.{i % nl}.weight"]).T.copy(),
            "bias": np_(named[f"{head}.{i % nl}.bias"]).copy()}
    p["log_std"] = np_(named["log_std"]).copy()
    return {"params": p}


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1.0)


def _tree_err(a, b):
    fa, fb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(fa) == len(fb)
    return max(_scaled(x, y) for x, y in zip(fa, fb))


def _rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(a), 1e-8)


CASES = {
    "base": dict(),
    "kl_guard": dict(target_kl=1e-4, epochs=3),
    "adaptive_lr": dict(target_kl=2e-3, adaptive_lr_kl=True),
    "lr_decay": dict(lr_final_frac=0.1),
    "clip_vf": dict(clip_vf=0.02),
    "shaping": dict(alive_bonus=0.5, alive_bonus_decay_steps=3 * B,
                    vel_shaping=0.3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ppo_iterations_match_jax(case):
    kw = dict(n_envs=N, horizon=H, minibatch_size=8, epochs=2, lr=1e-2,
              net_arch=ARCH, total_timesteps=ITERS * B, init_log_std=-0.5)
    kw.update(CASES[case])
    jppo = JPPO(JScripted(), JConfig(**kw))
    jppo.tx = optax.chain(_capture_first_grads(), jppo.tx)
    jts = jppo.init(seed=3)
    jts = jts._replace(
        env_states=(jnp.arange(N, dtype=jnp.int32),
                    jnp.zeros(N, jnp.int32)),
        last_obs=jnp.asarray(OBS_T[0]))
    cfg = tppo.PPOConfig(**kw)

    # the JAX key chain's draws, both iterations
    key, noises, perms = jts.key, [], []
    for _ in range(ITERS):
        for _ in range(H):
            key, akey = jax.random.split(key)
            noises.append(np.asarray(jax.random.normal(akey, (N, ACT))))
        for _ in range(cfg.epochs):
            key, pkey = jax.random.split(key)
            perms.append(np.asarray(jax.random.permutation(pkey, B)))
    tp = Forced(TScripted(), cfg, noises, perms)
    ts = tp.init(seed=0)
    ts.net.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jts.params), ARCH))
    assert _tree_err(jts.params, params_to_flax(ts.net.state_dict())) == 0

    for it in range(ITERS):
        p0 = jax.tree.map(np.asarray, jts.params)
        jfrac = 1.0
        if cfg.alive_bonus_decay_steps:
            jfrac = np.clip(1.0 - int(jts.global_step)
                            / cfg.alive_bonus_decay_steps, 0.0, 1.0)
        jts, js = jppo._train_iter(jts)
        ts, st = tp.train_iter(ts)

        # GAE on the batch the port collected, against the reference
        # recursion on the JAX net's values of the same obs
        obs, _, _, tval, tadv, tret = (x.numpy() for x in tp.batches[it])
        net = jnet.ActorCritic(ACT, net_arch=ARCH, init_log_std=-0.5)
        jval = np.asarray(net.apply(p0, jnp.asarray(obs))[2]).reshape(H, N)
        jlast = np.asarray(net.apply(
            p0, jnp.asarray(OBS_T[(it + 1) * H]))[2])
        assert _scaled(jval, tval.reshape(H, N)) < TOL_GAE
        done = DONE[it * H:(it + 1) * H].astype(np.float64)
        rew = REW[it * H:(it + 1) * H].astype(np.float64)
        vm = VM[it * H:(it + 1) * H].astype(np.float64)
        adv, vnext, want = np.zeros(N), jlast.astype(np.float64), []
        for t in reversed(range(H)):
            nt = 1.0 - done[t]
            rt = rew[t]
            if cfg.alive_bonus or cfg.vel_shaping:
                rt = rt + jfrac * (cfg.alive_bonus
                                   + cfg.vel_shaping * vm[t]) * nt
            delta = rt + cfg.gamma * vnext * nt - jval[t]
            adv = delta + cfg.gamma * cfg.gae_lambda * nt * adv
            want.append(adv)
            vnext = jval[t]
        want = np.stack(want[::-1])
        assert _scaled(want, tadv.reshape(H, N)) < TOL_GAE
        assert _scaled(want + jval, tret.reshape(H, N)) < TOL_GAE

        errs = {k: _rel(getattr(js, k), getattr(st, k))
                for k in ("pg_loss", "v_loss", "entropy", "approx_kl",
                          "clip_frac", "v_loss_max", "mean_reward",
                          "ep_return_sum", "ep_count", "ep_len_sum",
                          "log_std_mean")}
        errs["lr_scale"] = _rel(js.lr_scale, st.lr_scale)
        bad = {k: v for k, v in errs.items() if not v < TOL_LOSS}
        assert not bad, (it, bad)
        assert int(jts.global_step) == ts.global_step == (it + 1) * B
        perr = _tree_err(jts.params, params_to_flax(ts.net.state_dict()))
        assert perr < TOL_PARAM, (it, perr)

        if it == 0:
            # the first minibatch's raw gradients at the initial params
            net0 = tp.make_net()
            net0.load_state_dict(params_from_flax(p0, ARCH))
            mb = [x[torch.tensor(perms[0][:cfg.minibatch_size])]
                  for x in tp.batches[0]]
            tp.loss(net0, mb)[0].backward()
            tg = params_to_flax({k: p.grad for k, p in
                                 net0.named_parameters()})
            jg = jax.tree.map(np.asarray, jts.opt_state[0][1])
            assert _tree_err(jg, tg) < TOL_GRAD
    if case == "kl_guard":
        # the guard tripped after epoch 1: 2 updates, not 3 x 2
        assert ts.opt.count < ITERS * cfg.epochs * tp.n_minibatches
    if case == "adaptive_lr":
        assert ts.lr_scale != 1.0
    if case == "clip_vf":
        assert float(st.v_loss) > 0
    assert float(st.clip_frac) > 0 or case != "base"


def test_refuses_handoff_buffer():
    """The trainer no longer refuses the combined env's handoff buffer: an
    env with the hooks and HANDOFF_BUFFER_FRAC > 0 gets a buffer of
    ``handoff_buffer_cap`` rows in its train state; others get none."""
    caps = []

    class Combined(TScripted):
        class ENV_CFG:
            HANDOFF_BUFFER_FRAC = 0.2

        def make_handoff_buffer(self, cap):
            caps.append(cap)
            return "buffer"

    ppo = tppo.PPO(Combined(), tppo.PPOConfig(n_envs=N, horizon=H,
                                              handoff_buffer_cap=7))
    assert ppo._handoff
    assert ppo.init(seed=0).handoff_buf == "buffer" and caps == [7]
    Combined.ENV_CFG.HANDOFF_BUFFER_FRAC = 0.0
    plain = tppo.PPO(Combined(), tppo.PPOConfig(n_envs=N, horizon=H))
    assert not plain._handoff and plain.init(seed=0).handoff_buf is None
    assert tppo.PPO(TScripted(), tppo.PPOConfig(
        n_envs=N, horizon=H)).init(seed=0).handoff_buf is None
