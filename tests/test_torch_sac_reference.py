"""The port's SAC against the benchmark's plain float64 reference
(``benchmark/reference/sac.py``), its spans and counters, and the SAC
CLI's ``build``.

- ``SAC.update`` in float64 (the port's nets, optimizers and buffer cast
  to float64) against the reference's ``update`` from the same initial
  weights, on the rows and noises the port drew, at obs 85, action 23,
  widths (64, 32), batch 16, three updates: the losses, the Q target,
  the critic, actor and alpha gradients after each update, and the
  actor, critics, target critics and log alpha after the three. Both
  compute in float64 with the operations in another order (``F.linear``
  against ``x @ W.T + b``, Adam's step rearranged), so they agree to
  rounding: 1e-9, scaled by max(1, the largest |reference|).
- The reference's initial weights from the seed equal the port's bit
  for bit (both draw flax's truncated normal from one CPU generator).
- A traced ``train_iter`` records the ``sac.*`` spans, nested as the
  port's docstring says, and the ``sac.updates`` and ``sac.buffer_rows``
  counters.
- ``sac_train.build`` of the recorded SAC walk recipe's argv at the
  Unitree G1 gives the benchmark traffic's ``SACConfig``.
"""
import importlib.util
import json
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from deepmimic_mujoco_tpu_torch.rl import sac as tsac
from deepmimic_mujoco_tpu_torch.rl import sac_train
from deepmimic_mujoco_tpu_torch.rl.ppo import Adam
from deepmimic_mujoco_tpu_torch.utils import tracing

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BENCH = os.path.join(_REPO, "benchmark")


def _load(path: str, name: str):
    """A module of the benchmark loaded by its path (the benchmark's
    folder stays off ``sys.path``: its package names would shadow)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


rsac = _load(os.path.join(_BENCH, "reference", "sac.py"),
             "bench_reference_sac")

OBS, ACT, ARCH, BATCH, UPDATES = 85, 23, (64, 32), 16, 3
N_ENVS, BUF, FILLED = 4, 64, 40
TOL = 1e-9


class Out(NamedTuple):
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


class Table:
    """An env whose obs, rewards and dones come from a seeded table,
    whatever the actions."""
    obs_size, action_size = OBS, ACT
    device = torch.device("cpu")

    def __init__(self, steps: int = 4):
        r = np.random.RandomState(5)
        self.obs = torch.tensor(r.randn(steps + 1, N_ENVS, OBS),
                                dtype=torch.float32)
        self.rew = torch.tensor(r.uniform(0, 1, (steps, N_ENVS)),
                                dtype=torch.float32)
        self.done = torch.tensor(r.rand(steps, N_ENVS) < 0.25)

    def reset(self, n_envs, generator=None):
        return 0, self.obs[0]

    def step_auto_reset(self, t, action, generator=None):
        return t + 1, Out(self.obs[t + 1], self.rew[t], self.done[t])


class Recording(tsac.SAC):
    """The port's trainer, keeping each update's draws, Q target and the
    gradients its three optimizers got."""

    def __init__(self, env, cfg):
        super().__init__(env, cfg)
        self.rec = []

    def draw_idx(self, s, valid):
        idx = super().draw_idx(s, valid)
        self.rec.append(dict(idx=idx))
        return idx

    def draw_next_noise(self, s, mean):
        self.rec[-1]["next"] = super().draw_next_noise(s, mean)
        return self.rec[-1]["next"]

    def draw_pi_noise(self, s, mean):
        self.rec[-1]["pi"] = super().draw_pi_noise(s, mean)
        return self.rec[-1]["pi"]

    def q_target(self, s, *a):
        self.rec[-1]["q_target"] = super().q_target(s, *a)
        return self.rec[-1]["q_target"]

    def update_step(self, s, valid, warm):
        out = super().update_step(s, valid, warm)
        grads = lambda prefix, m: {f"{prefix}.{k}": p.grad.clone()
                                   for k, p in m.named_parameters()}
        self.rec[-1].update(critic_grad=grads("critic", s.critic),
                            actor_grad=grads("actor", s.actor),
                            alpha_grad=s.log_alpha.grad.clone(),
                            log_alpha=s.log_alpha.detach().clone())
        return out


def _params(s):
    return {**{f"actor.{k}": v.detach()
               for k, v in s.actor.named_parameters()},
            **{f"critic.{k}": v.detach()
               for k, v in s.critic.named_parameters()}}


def _to_float64(s):
    """The port's state in float64: nets, log alpha, optimizers, buffer."""
    for m in (s.actor, s.critic, s.target_critic):
        m.double()
    s.log_alpha = torch.zeros((), dtype=torch.float64, requires_grad=True)
    s.opt_actor = Adam(s.actor.parameters(), eps=tsac.ADAM_EPS)
    s.opt_critic = Adam(s.critic.parameters(), eps=tsac.ADAM_EPS)
    s.opt_alpha = Adam([s.log_alpha], eps=tsac.ADAM_EPS)
    r = np.random.RandomState(11)
    s.buffer = dict(
        obs=torch.tensor(3 * r.randn(BUF, OBS)),
        action=torch.tensor(r.uniform(-1, 1, (BUF, ACT))),
        reward=torch.tensor(r.uniform(0, 1, BUF)),
        next_obs=torch.tensor(3 * r.randn(BUF, OBS)),
        done=torch.tensor((r.rand(BUF) < 0.2).astype(np.float64)))


def _scaled(got, want):
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


CASES = {
    "defaults": (dict(), 1.0, FILLED),
    "critic_warmup": (dict(critic_warmup_steps=10 ** 9), 0.0, FILLED),
    "actor_lr": (dict(actor_lr=3e-3), 1.0, FILLED),
    # a floor above the start: the first step (0.5 at most, either way)
    # lands under it, and the clamp lifts log alpha onto the floor
    "alpha_floor": (dict(alpha_lr=0.5, log_alpha_min=0.6), 1.0, FILLED),
    "wrapped": (dict(), 1.0, BUF),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_matches_the_float64_reference(case):
    kw, warm, valid = CASES[case]
    cfg = tsac.SACConfig(n_envs=N_ENVS, buffer_size=BUF, batch_size=BATCH,
                         steps_per_iter=4, updates_per_iter=UPDATES,
                         net_arch=ARCH, lr=1e-3, **kw)
    sac = Recording(Table(), cfg)
    s = sac.init(seed=7)
    p0 = rsac.init_params(OBS, ACT, ARCH, seed=7)
    got0 = _params(s)
    assert set(got0) == set(p0)
    for k in p0:
        assert torch.equal(got0[k], p0[k]), k
    _to_float64(s)
    losses = sac.update(s, valid, warm)
    assert losses.shape == (UPDATES, 2)

    hp = dict(gamma=cfg.gamma, tau=cfg.tau, lr=cfg.lr, actor_lr=cfg.actor_lr,
              alpha_lr=cfg.alpha_lr, log_alpha_min=cfg.log_alpha_min)
    st = rsac.State({k: v.double() for k, v in p0.items()})
    for k, rec in enumerate(sac.rec):
        assert int(rec["idx"].max()) < valid
        batch = [s.buffer[f][rec["idx"]] for f in tsac.BUFFER_FIELDS]
        want = rsac.update(st, batch, rec["next"], rec["pi"], hp, warm)
        assert abs(float(losses[k, 0]) - want["critic_loss"]) \
            <= TOL * abs(want["critic_loss"])
        assert abs(float(losses[k, 1]) - want["actor_loss"]) \
            <= TOL * max(1.0, abs(want["actor_loss"]))
        assert _scaled(rec["q_target"], want["q_target"]) < TOL
        for name in ("critic_grad", "actor_grad"):
            assert max(_scaled(rec[name][p], g)
                       for p, g in want[name].items()) < TOL, (case, k, name)
        assert _scaled(rec["alpha_grad"], want["alpha_grad"]) < TOL
        assert _scaled(rec["log_alpha"], st.log_alpha) < TOL
    if warm == 0.0:
        assert all(not float(g.abs().max())
                   for g in want["actor_grad"].values())
    got = _params(s)
    assert max(_scaled(got[k], st.params[k]) for k in got) < TOL
    tgt = {f"critic.{k}": v for k, v in s.target_critic.named_parameters()}
    assert max(_scaled(tgt[k], st.target[k]) for k in st.target) < TOL
    assert _scaled(s.log_alpha, st.log_alpha) < TOL
    if case == "alpha_floor":
        assert float(sac.rec[0]["log_alpha"]) == 0.6
    # the target moved by Polyak steps from the critics' initial weights
    assert max(_scaled(tgt[k], p0[k].double()) for k in st.target) > 0


def test_traced_iteration_records_the_sac_spans():
    cfg = tsac.SACConfig(n_envs=N_ENVS, buffer_size=BUF, batch_size=BATCH,
                         steps_per_iter=4, updates_per_iter=UPDATES,
                         net_arch=(16,))
    tracing.reset()
    try:
        sac = tsac.SAC(Table(steps=8), cfg)
        s = sac.init(seed=1)
        with tracing.collect():
            s, _ = sac.train_iter(s)
        snap = tracing.snapshot()
    finally:
        tracing.reset()
    by_id = {sp.id: sp for sp in snap.spans}
    names = [sp.name for sp in snap.spans]
    assert names.count("setup.train_state") == 1
    assert names.count("sac.iter") == names.count("sac.collect") == 1
    assert names.count("sac.update") == 1
    assert names.count("sac.policy") == names.count("sac.buffer_write") == 4
    assert names.count("sac.update_step") == UPDATES
    parent = {"sac.collect": "sac.iter", "sac.update": "sac.iter",
              "sac.policy": "sac.collect", "sac.buffer_write": "sac.collect",
              "sac.update_step": "sac.update"}
    for sp in snap.spans:
        if sp.name in parent:
            assert by_id[sp.parent].name == parent[sp.name]
    assert snap.calls("sac.updates") == UPDATES
    assert snap.total("sac.updates") == UPDATES
    # one iteration of 4 x 4 rows: each update draws from the 16 written
    assert snap.calls("sac.buffer_rows") == UPDATES
    assert snap.total("sac.buffer_rows") == UPDATES * 16
    # off, nothing but set-up is recorded
    s, _ = sac.train_iter(s)
    assert not [sp for sp in tracing.snapshot().spans
                if sp.name.startswith("sac.")]


RECIPE = ["ns-sac-walk", "--robot", "unitree_g1", "--motion", "walk",
          "--n-envs", "512", "--buffer", "5000000", "--batch", "2048",
          "--steps-per-iter", "16", "--updates-per-iter", "48", "--arch",
          "1024", "512", "--device", "cpu"]


def test_build_gives_the_recipes_config():
    with open(os.path.join(_BENCH, "traffic", "sac_walk.json")) as fh:
        hp = json.load(fh)["sac"]
    with open(os.path.join(_BENCH, "configs", "unitree_g1_sac.json")) as fh:
        model = json.load(fh)
    env, cfg = sac_train.build(sac_train.parse_args(RECIPE))
    assert (env.obs_size, env.action_size) == (model["obs_size"],
                                               model["action_size"])
    assert env.engine.max_contacts == model["max_contacts"]
    assert cfg == tsac.SACConfig(
        n_envs=hp["n_envs"], buffer_size=model["buffer_size"],
        batch_size=hp["minibatch_size"], steps_per_iter=hp["horizon"],
        updates_per_iter=hp["updates_per_iter"], lr=hp["lr"],
        gamma=hp["gamma"], tau=hp["tau"], net_arch=tuple(hp["net_arch"]),
        alpha_lr=hp["alpha_lr"], log_alpha_min=hp["log_alpha_min"],
        critic_warmup_steps=hp["critic_warmup"],
        total_timesteps=sac_train.parse_args(RECIPE).total)
    assert list(cfg.net_arch) == model["net_arch"]
