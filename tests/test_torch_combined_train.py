"""Port parity and behaviour of training on the combined env: PPO with
the on-policy handoff buffer against the JAX package, the training CLI
with its default (combined) env on the CPU, ``play_combined`` and its
recovery-cycle counter, and the combined gate actor.

The PPO case uses a scripted env, written here for both frameworks, with
the combined env's three handoff hooks (the packages' own
``handoff_capture_mask`` and ``update_handoff_buffer``): its motion ids,
player actions, states, obs, rewards and dones come from a table made
with numpy from a seed, and its rewards read the buffer's row count, so
the buffer feeds back into the losses. The JAX package's draws are handed
to the port as in tests/test_torch_ppo.py. Held: the buffer exactly,
``handoff_count`` exactly, losses and KL to 1e-5 relative, params to
1e-5 scaled.
"""
import functools
import glob
import json
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.envs import combined_env as jce
from deepmimic_mujoco_tpu.rl.ppo import PPO as JPPO
from deepmimic_mujoco_tpu.rl.ppo import PPOConfig as JConfig

from deepmimic_mujoco_tpu_torch.envs import combined_env as tce
from deepmimic_mujoco_tpu_torch.rl import eval as rl_eval
from deepmimic_mujoco_tpu_torch.rl import ppo as tppo
from deepmimic_mujoco_tpu_torch.rl.convert import params_from_flax
from deepmimic_mujoco_tpu_torch.rl.train import main
from deepmimic_mujoco_tpu_torch.tools import play_combined
from test_torch_ppo import Forced, _rel, _tree_err, params_to_flax

WALK, RUN, GETUP, TO_GETUP = 0, 1, 2, 3
N, H, OBS, ACT, NQ, NV = 6, 4, 5, 3, 3, 2
ITERS, CAP = 2, 5
ARCH = (16,)
B = N * H
TOL_LOSS = 1e-5
TOL_PARAM = 1e-5
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMBINED_NPZ = os.path.join(_REPO, "deepmimic_mujoco_tpu_torch", "data",
                            "combined_r5_best_actor.npz")

r = np.random.RandomState(1)
T = ITERS * H + 1
OBS_T = r.randn(T, N, OBS).astype(np.float32)
REW = r.uniform(0, 1, (T, N)).astype(np.float32)
DONE = r.rand(T, N) < 0.15
# GETUP often, so envs leave it for locomotion often
MOT = r.choice([WALK, RUN, GETUP, GETUP, TO_GETUP], (T, N))
PA = r.randint(0, 2, (T, N))
Q = r.randn(T, N, NQ).astype(np.float32)
V = r.randn(T, N, NV).astype(np.float32)


class Cfg:
    HANDOFF_BUFFER_FRAC = 0.5


class JState(NamedTuple):
    i: object
    t: object
    motion_id: object
    player_action: object
    qpos: object
    qvel: object


class JOut(NamedTuple):
    obs: object
    reward: object
    done: object
    motion_id: object


class JScripted:
    """The table env for the JAX trainer, with the handoff hooks."""
    obs_size, action_size = OBS, ACT
    ENV_CFG = Cfg()
    handoff_capture_mask = staticmethod(
        jce.DPCombinedEnv.handoff_capture_mask)
    update_handoff_buffer = staticmethod(
        jce.DPCombinedEnv.update_handoff_buffer)

    def make_handoff_buffer(self, cap):
        return jce.HandoffBuffer(
            qpos=jnp.zeros((cap, NQ)), qvel=jnp.zeros((cap, NV)),
            pa=jnp.zeros(cap, jnp.int32), motion=jnp.full(cap, RUN,
                                                          jnp.int32),
            head=jnp.zeros((), jnp.int32), count=jnp.zeros((), jnp.int32))

    def reset(self, key):
        return (JState(*(jnp.int32(0),) * 4, jnp.zeros(NQ), jnp.zeros(NV)),
                jnp.zeros(OBS, jnp.float32))

    def step_auto_reset(self, s, action, hbuf):
        i, t1 = s.i, s.t + 1
        at = lambda x: jnp.asarray(x)[t1, i]
        rew = jnp.asarray(REW)[s.t, i] + 0.05 * hbuf.count
        return (JState(i, t1, at(MOT), at(PA), at(Q), at(V)),
                JOut(at(OBS_T), rew, jnp.asarray(DONE)[s.t, i], at(MOT)))


class TState(NamedTuple):
    t: torch.Tensor
    motion_id: torch.Tensor
    player_action: torch.Tensor
    qpos: torch.Tensor
    qvel: torch.Tensor


class TOut(NamedTuple):
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    motion_id: torch.Tensor
    contact_overflow: torch.Tensor


class TScripted:
    """The same table env for the port."""
    obs_size, action_size = OBS, ACT
    device = torch.device("cpu")
    ENV_CFG = Cfg()
    handoff_capture_mask = staticmethod(
        tce.DPCombinedEnv.handoff_capture_mask)
    update_handoff_buffer = staticmethod(
        tce.DPCombinedEnv.update_handoff_buffer)

    def make_handoff_buffer(self, cap):
        return tce.HandoffBuffer(
            qpos=torch.zeros(cap, NQ), qvel=torch.zeros(cap, NV),
            pa=torch.zeros(cap, dtype=torch.int64),
            motion=torch.full((cap,), RUN, dtype=torch.int64),
            head=torch.zeros((), dtype=torch.int64),
            count=torch.zeros((), dtype=torch.int64))

    def _state(self, t):
        f = lambda x: torch.tensor(x[t])
        return TState(torch.tensor(t), f(MOT), f(PA), f(Q), f(V))

    def reset(self, n_envs, generator=None):
        return self._state(0), torch.tensor(OBS_T[0])

    def step_auto_reset(self, s, action, generator=None, handoff_buf=None):
        t = int(s.t)
        rew = torch.tensor(REW[t]) + 0.05 * handoff_buf.count
        return self._state(t + 1), TOut(
            torch.tensor(OBS_T[t + 1]), rew, torch.tensor(DONE[t]),
            torch.tensor(MOT[t + 1]), torch.zeros(N, dtype=torch.int64))


def test_ppo_handoff_buffer_iterations_match_jax():
    kw = dict(n_envs=N, horizon=H, minibatch_size=8, epochs=2, lr=1e-2,
              net_arch=ARCH, total_timesteps=ITERS * B, init_log_std=-0.5,
              handoff_buffer_cap=CAP)
    jppo = JPPO(JScripted(), JConfig(**kw))
    jts = jppo.init(seed=4)
    # the JAX table env starts at the table's first row, like the port's
    jts = jts._replace(
        env_states=JState(jnp.arange(N, dtype=jnp.int32),
                          jnp.zeros(N, jnp.int32), jnp.asarray(MOT[0]),
                          jnp.asarray(PA[0]), jnp.asarray(Q[0]),
                          jnp.asarray(V[0])),
        last_obs=jnp.asarray(OBS_T[0]))
    cfg = tppo.PPOConfig(**kw)
    key, noises, perms = jts.key, [], []
    for _ in range(ITERS):
        for _ in range(H):
            key, akey = jax.random.split(key)
            noises.append(np.asarray(jax.random.normal(akey, (N, ACT))))
        for _ in range(cfg.epochs):
            key, pkey = jax.random.split(key)
            perms.append(np.asarray(jax.random.permutation(pkey, B)))
    tp = Forced(TScripted(), cfg, noises, perms)
    assert tp._handoff
    ts = tp.init(seed=0)
    assert int(ts.handoff_buf.count) == 0
    assert ts.handoff_buf.qpos.shape == (CAP, NQ)
    ts.net.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jts.params), ARCH))
    for it in range(ITERS):
        jts, js = jppo._train_iter(jts)
        ts, st = tp.train_iter(ts)
        for k in jts.handoff_buf._fields:
            np.testing.assert_array_equal(
                getattr(ts.handoff_buf, k).numpy(),
                np.asarray(getattr(jts.handoff_buf, k)), err_msg=k)
        assert int(st.handoff_count) == int(js.handoff_count) > 0
        errs = {k: _rel(getattr(js, k), getattr(st, k))
                for k in ("pg_loss", "v_loss", "entropy", "approx_kl",
                          "clip_frac", "mean_reward", "ep_return_sum")}
        bad = {k: v for k, v in errs.items() if not v < TOL_LOSS}
        assert not bad, (it, bad)
        perr = _tree_err(jts.params, params_to_flax(ts.net.state_dict()))
        assert perr < TOL_PARAM, (it, perr)
    # the table's captures overran the ring, so it wrapped
    caught = ((MOT[:-1] == GETUP) & np.isin(MOT[1:], [WALK, RUN])
              & ~DONE[:-1]).sum()
    assert caught > CAP and int(ts.handoff_buf.count) == CAP
    assert int(ts.handoff_buf.head) == caught % CAP


def test_checkpoint_keeps_the_handoff_buffer(tmp_path):
    """The train state's handoff buffer survives a save and restore."""
    from deepmimic_mujoco_tpu_torch.rl import checkpoint

    cfg = tppo.PPOConfig(n_envs=N, horizon=H, minibatch_size=8, epochs=1,
                         net_arch=ARCH, total_timesteps=2 * B,
                         handoff_buffer_cap=CAP)
    ppo = tppo.PPO(TScripted(), cfg)
    ts, _ = ppo.train_iter(ppo.init(seed=1))
    assert int(ts.handoff_buf.count) > 0
    path = checkpoint.save(str(tmp_path / "state.pt"), ts)
    back = checkpoint.restore(path, ppo.init(seed=2))
    for a, b in zip(ts.handoff_buf, back.handoff_buf):
        assert torch.equal(a, b)


@pytest.fixture
def short_evals(monkeypatch):
    """The CLI's evaluation episodes cut to 8 steps (a combined episode
    runs to its 2000-step cap)."""
    monkeypatch.setattr(rl_eval, "eval_dashboard_rollout", functools.partial(
        rl_eval.eval_dashboard_rollout, max_steps=8))


def test_cli_trains_combined_env_on_cpu(tmp_path, short_evals,
                                       monkeypatch):
    """The default --env (the combined env) with every combined flag and
    --rk4, at a tiny size."""
    from deepmimic_mujoco_tpu_torch.physics import solver

    solves = []
    entry = solver.fused_solve_parts
    monkeypatch.setattr(solver, "fused_solve_parts",
                        lambda *a, **k: solves.append(1) or entry(*a, **k))
    ts = main(["smoke", "--n-envs", "4", "--horizon", "3", "--minibatch",
               "6", "--epochs", "1", "--total", "24", "--no-wandb",
               "--no-render", "--device", "cpu", "--out", str(tmp_path),
               "--handoff-rsi", "0.3", "--rsi-random-pa",
               "--handoff-buffer", "0.5", "--handoff-buffer-cap", "16",
               "--facedown-rsi", "0.2", "--rk4"])
    assert ts.global_step == 24
    # RK4: four solves per step, 2 iterations x 3 steps and the 8-step
    # evaluation episode
    assert len(solves) == 4 * (2 * 3 + 8)
    # the cap is parsed and reaches nothing, as in the JAX CLI
    assert ts.handoff_buf.qpos.shape == (tppo.PPOConfig().handoff_buffer_cap,
                                         44)
    rows = [json.loads(line) for line in open(glob.glob(
        str(tmp_path / "*_metrics.jsonl"))[0])]
    conf = rows[0]["config"]
    assert conf["env_name"] == "dp_combined_env"
    assert conf["env_cfg"] == dict(conf["env_cfg"], HANDOFF_RSI_FRAC=0.3,
                                   RSI_RANDOM_PA=True,
                                   HANDOFF_BUFFER_FRAC=0.5,
                                   FACEDOWN_RSI_FRAC=0.2)
    iters = [r for r in rows if "pg_loss" in r]
    assert [r["global_step"] for r in iters] == [12, 24]
    assert all("handoff_count" in r and np.isfinite(r["pg_loss"])
               for r in iters)
    evals = [r for r in rows if "eval_episode_reward" in r]
    assert evals and evals[0]["eval_episode_length"] == 8
    saved = torch.load(glob.glob(str(tmp_path / "test*.pt"))[0],
                       weights_only=True)
    assert saved["handoff_buf"]["count"] == ts.handoff_buf.count


def _gate_rule(motions, heights):
    """tests/test_checkpoint_gates.py's cycle accounting over a sequence
    of motion ids (the first is the start) and root heights."""
    saw_tg, cycles = False, 0
    for prev, cur, z in zip(motions[:-1], motions[1:], heights[1:]):
        changed = cur != prev
        saw_tg = saw_tg or (changed and cur == TO_GETUP)
        completed = (changed and prev == GETUP and cur in (WALK, RUN)
                     and saw_tg and z > 0.5)
        cycles += int(completed)
        saw_tg = saw_tg and not completed
    return cycles


def test_cycle_counter_follows_the_gate_rule():
    seqs = [
        # fall, to_getup, getup, up at the switch: one cycle
        ([WALK, TO_GETUP, GETUP, RUN], [0.8, 0.3, 0.2, 0.79]),
        # the getup timer fires lying down: no cycle, still armed
        ([WALK, TO_GETUP, GETUP, RUN, TO_GETUP, GETUP, WALK],
         [0.8, 0.3, 0.2, 0.1, 0.2, 0.3, 0.7]),
        # a getup start with no fall first: no cycle
        ([GETUP, RUN, WALK], [0.2, 0.8, 0.8]),
    ]
    rng = np.random.RandomState(2)
    for _ in range(40):
        n = rng.randint(2, 30)
        seqs.append((list(rng.choice([WALK, RUN, GETUP, TO_GETUP], n)),
                     list(rng.uniform(0.0, 1.0, n))))
    got = []
    for motions, heights in seqs:
        c = play_combined.CycleCounter()
        for prev, cur, z in zip(motions[:-1], motions[1:], heights[1:]):
            c.update(prev, cur, z)
        assert c.cycles == _gate_rule(motions, heights), (motions, heights)
        got.append(c.cycles)
    assert got[:3] == [1, 1, 0]
    assert max(got) >= 1


def test_play_combined_runs_a_few_steps(capsys, tmp_path):
    import cv2

    video = tmp_path / "combined.mp4"
    ep_rew, cycles = play_combined.main([
        "--checkpoint", COMBINED_NPZ, "--steps", "12", "--warmstart", "4",
        "--inject-fall-every", "4", "--device", "cpu", "--video",
        str(video)])
    out = capsys.readouterr().out
    assert np.isfinite(ep_rew) and ep_rew > 0 and cycles == 0
    assert "injecting fall" in out and "changing to motion: to_getup" in out
    # every 4th of the 12 steps rendered, with the motion overlay
    assert "done at" not in out and f"Saved {video}" in out
    cap = cv2.VideoCapture(str(video))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3
    ok, frame = cap.read()
    cap.release()
    assert ok and frame.shape == (480, 480, 3) and frame.std() > 20


def test_combined_npz_matches_orbax_checkpoint():
    """Provenance of the shipped combined actor (obs include the
    player-action block): every array equals runs/combined_r5_best."""
    from deepmimic_mujoco_tpu.rl.checkpoint import restore_params

    p = restore_params(os.path.join(_REPO, "runs/combined_r5_best"))["params"]
    npz = np.load(COMBINED_NPZ)
    assert sorted(npz.files) == ["b0", "b1", "b2", "log_std",
                                 "w0", "w1", "w2"]
    assert npz["w0"].shape == (98, 256) and npz["w2"].shape == (128, 23)
    for i in range(3):
        np.testing.assert_array_equal(npz[f"w{i}"],
                                      np.asarray(p[f"Dense_{i}"]["kernel"]))
        np.testing.assert_array_equal(npz[f"b{i}"],
                                      np.asarray(p[f"Dense_{i}"]["bias"]))
    np.testing.assert_array_equal(npz["log_std"], np.asarray(p["log_std"]))
