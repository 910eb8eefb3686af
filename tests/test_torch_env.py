"""Port parity: DPEnv (humanoid3d walk) of the torch port vs the JAX
package on the CPU.

torch cannot reproduce JAX's random streams, so both envs start from
forced clip frames (``idx_init`` per env) and take the same fixed
actions made with numpy. Obs and reward are held to max|d|/scale < 5e-3
(the end-to-end tolerance of tests/test_fused_solve.py); done and
done_reason must be equal. One env gets a NaN action, which the
divergence guard must catch in both, and a short MAX_EP_LENGTH makes
the episode-length rule fire inside the run.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.envs import DPEnv as JDPEnv
from deepmimic_mujoco_tpu.envs.config import DPEnvConfig as JConfig

from deepmimic_mujoco_tpu_torch.envs import DPEnv, DPEnvConfig
from deepmimic_mujoco_tpu_torch.envs import dp_env as tdp

TOL = 5e-3
N_STEPS = 4
FRAMES = np.array([0, 9, 20, 33, 48, 75])


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1.0)


@pytest.fixture(scope="module")
def envs():
    je = JDPEnv(motion="walk", robot="humanoid3d",
                cfg=JConfig(MAX_EP_LENGTH=3))
    te = DPEnv(motion="walk", robot="humanoid3d",
               cfg=DPEnvConfig(MAX_EP_LENGTH=3), device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(0), len(FRAMES))
    jreset = jax.jit(jax.vmap(lambda k, i: je.reset(k, idx_init=i)))(
        keys, jnp.asarray(FRAMES))
    return je, te, jreset


def test_reset_matches(envs):
    je, te, (_, jobs) = envs
    state, tobs = te.reset(len(FRAMES), idx_init=torch.tensor(FRAMES))
    assert _err(jobs, tobs.numpy()) < 1e-5
    np.testing.assert_array_equal(state.idx_curr.numpy(), FRAMES)
    with pytest.raises(ValueError):
        te.reset(2, idx_init=te.mocap_data_len)


def test_steps_match(envs):
    je, te, (js, _) = envs
    B = len(FRAMES)
    r = np.random.RandomState(5)
    actions = (r.uniform(-1, 1, (N_STEPS, B, je.action_size))
               * 50).astype(np.float32)
    actions[:, -1] = np.nan            # the divergence guard's case
    ts, _ = te.reset(B, idx_init=torch.tensor(FRAMES))
    jstep = jax.jit(jax.vmap(je.step))
    reasons = set()
    for t in range(N_STEPS):
        js, jo = jstep(js, jnp.asarray(actions[t]))
        ts, to = te.step(ts, torch.tensor(actions[t]))
        np.testing.assert_array_equal(to.done.numpy(), np.asarray(jo.done))
        np.testing.assert_array_equal(to.done_reason.numpy(),
                                      np.asarray(jo.done_reason))
        np.testing.assert_array_equal(to.contact_overflow.numpy(),
                                      np.asarray(jo.contact_overflow))
        errs = {"obs": _err(jo.obs, to.obs.numpy()),
                "reward": _err(jo.reward, to.reward.numpy()),
                "qpos": _err(js.qpos, ts.qpos.numpy()),
                "qvel": _err(js.qvel, ts.qvel.numpy()),
                "vel_match": _err(jo.vel_match, to.vel_match.numpy())}
        bad = {k: v for k, v in errs.items() if not v < TOL}
        assert not bad, (t, bad)
        reasons |= set(to.done_reason.tolist())
    assert tdp.DONE_OBS_OOB in reasons
    assert tdp.DONE_MAX_EP_LEN in reasons


def test_step_auto_reset_resets_done_envs(envs):
    te = envs[1]
    B = 4
    g = torch.Generator().manual_seed(0)
    state, _ = te.reset(B, idx_init=torch.tensor([5, 6, 7, 8]))
    action = torch.zeros(B, te.action_size)
    action[0] = float("nan")
    nxt, out = te.step_auto_reset(state, action, g)
    assert out.done.tolist() == [True, False, False, False]
    assert int(nxt.episode_length[0]) == 0
    assert float(nxt.episode_reward[0]) == 0.0
    f = int(nxt.idx_curr[0])
    torch.testing.assert_close(nxt.qpos[0], te.mocap_qpos[f])
    torch.testing.assert_close(nxt.lam[0], te.engine.empty_lam(1)[0])
    assert nxt.idx_curr[1:].tolist() == [7, 8, 9]
    assert nxt.episode_length[1:].tolist() == [1, 1, 1]
