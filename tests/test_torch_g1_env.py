"""Port parity: DPEnv at the Unitree G1 (walk, run, getup) against the
JAX package on the CPU.

Both envs start from forced clip frames and take the same actions made
with numpy (the JAX env's build and step compile dominate this file's
time). Reset obs are held to
1e-5 relative to their scale. A step goes through the constraint solve
(the JAX package's XLA fallback against the port's Cholesky-based plain
version), so obs, rewards and states after a step are held to 5e-3, the
end-to-end tolerance of tests/test_fused_solve.py; done, done reasons
and contact overflow must be equal. The run tips one env past the 60
degree roll limit, so ``check_run_angles`` fires.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.envs import DPEnv as JDPEnv

from deepmimic_mujoco_tpu_torch.envs import DPEnv
from deepmimic_mujoco_tpu_torch.envs import dp_env as tdp

TOL = 1e-5
TOL_STEP = 5e-3
N_STEPS = 3


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1.0)


def _roll(qpos, deg):
    """Root quaternion (w, x, y, z) turned by ``deg`` about world x."""
    a = np.deg2rad(deg) / 2
    w1, x1 = np.cos(a), np.sin(a)
    w2, x2, y2, z2 = qpos[:, 3:7].T
    out = qpos.copy()
    out[:, 3:7] = np.stack([w1 * w2 - x1 * x2, w1 * x2 + x1 * w2,
                            w1 * y2 - x1 * z2, w1 * z2 + x1 * y2], 1)
    return out.astype(np.float32)


def check_env_steps(motion, frames, tip):
    je = JDPEnv(motion=motion, robot="unitree_g1")
    te = DPEnv(motion=motion, robot="unitree_g1", device="cpu")
    assert (je.obs_size, je.action_size) == (te.obs_size, te.action_size) \
        == (85, 23)
    assert te.spec.n_hand_actions == je.spec.n_hand_actions == 14
    assert te.check_run_angles == je.check_run_angles == (motion == "run")
    assert te.is_acyclical == je.is_acyclical
    assert te.engine.n_constraint_rows == 3 * 24 + 37
    B = len(frames)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    js, jobs0 = jax.jit(jax.vmap(lambda k, i: je.reset(k, idx_init=i)))(
        keys, jnp.asarray(frames))
    ts, tobs0 = te.reset(B, idx_init=torch.tensor(frames))
    assert _err(jobs0, tobs0.numpy()) < TOL
    np.testing.assert_array_equal(ts.idx_curr.numpy(), frames)
    if tip:   # the last env tipped past the 60-degree roll limit
        q0 = ts.qpos.numpy()
        q0 = np.concatenate([q0[:-1], _roll(q0[-1:], 75.0)])
        js = js._replace(qpos=jnp.asarray(q0))
        ts = ts._replace(qpos=torch.tensor(q0))
    r = np.random.RandomState(3)
    jstep = jax.jit(jax.vmap(je.step))
    reasons = set()
    for t in range(N_STEPS):
        a = (r.uniform(-1, 1, (B, te.action_size)) * 0.5).astype(np.float32)
        js, jo = jstep(js, jnp.asarray(a))
        ts, to = te.step(ts, torch.tensor(a))
        np.testing.assert_array_equal(to.done_reason.numpy(),
                                      np.asarray(jo.done_reason))
        np.testing.assert_array_equal(to.done.numpy(), np.asarray(jo.done))
        np.testing.assert_array_equal(to.contact_overflow.numpy(),
                                      np.asarray(jo.contact_overflow))
        errs = {"obs": _err(jo.obs, to.obs.numpy()),
                "reward": _err(jo.reward, to.reward.numpy()),
                "qpos": _err(js.qpos, ts.qpos.numpy()),
                "qvel": _err(js.qvel, ts.qvel.numpy())}
        bad = {k: v for k, v in errs.items() if not v < TOL_STEP}
        assert not bad, (t, bad)
        reasons |= set(to.done_reason.tolist())
    if tip:
        assert tdp.DONE_RUN_ROLL in reasons
    if te.is_acyclical:
        assert tdp.DONE_ACYCLICAL_END in reasons


# the getup from frame 0 is in tests/test_torch_g1_getup.py: each G1 env
# costs ~35 s of JAX build and compile on the CPU
@pytest.mark.parametrize("motion,frames,tip", [
    ("walk", [0, 5, 20, 45], False),
    ("run", [5, 20, 30, 40], True),
], ids=["walk", "run"])
def test_g1_env_steps_match(motion, frames, tip):
    check_env_steps(motion, frames, tip)
