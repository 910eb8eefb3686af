"""Port parity: the combined walk/run/getup env (DPCombinedEnv) against
the JAX package on the CPU.

The JAX env is built once for the module, and each of its functions is
compiled once, vmapped over a batch built to reach every branch: reset,
a force-state step (with and without ``getup_timeout_to_walk``) and a
physics ``step_auto_reset`` with the handoff buffer armed. The port
takes the JAX package's random draws as forced ``ResetDraws``, derived
here from the same keys the JAX env splits.

Held exactly: motion ids, ``n_steps``, player actions, done, done
reasons, the handoff buffer. Obs and rewards: 1e-5 scaled on reset and
force-state (kinematic) steps; 5e-3 scaled after a physics step, where
the JAX package's XLA-fallback solve and the port's Cholesky-based plain
version differ (the end-to-end tolerance of tests/test_fused_solve.py).
"""
import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.envs import DPCombinedEnv as JEnv
from deepmimic_mujoco_tpu.envs import combined_env as jce
from deepmimic_mujoco_tpu.envs import obs as jobs
from deepmimic_mujoco_tpu.envs.config import DPCombinedEnvConfig as JCfg

from deepmimic_mujoco_tpu_torch.envs import DPCombinedEnv
from deepmimic_mujoco_tpu_torch.envs import combined_env as tce
from deepmimic_mujoco_tpu_torch.envs import obs as tobs
from deepmimic_mujoco_tpu_torch.envs.config import DPCombinedEnvConfig

WALK, RUN, GETUP, TO_GETUP = 0, 1, 2, 3
TOL = 1e-5
TOL_STEP = 5e-3
OPTS = dict(HANDOFF_RSI_FRAC=0.3, RSI_RANDOM_PA=True,
            HANDOFF_BUFFER_FRAC=0.5, FACEDOWN_RSI_FRAC=0.2)
START = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "deepmimic_mujoco_tpu_torch", "data",
    "combined_gate_start.npz")


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1.0)


def _with_cfg(env, cfg):
    """The same env (model, clips, engine) under another config: both
    envs read ``ENV_CFG`` when they draw a reset."""
    out = copy.copy(env)
    out.ENV_CFG = cfg
    return out


@pytest.fixture(scope="module")
def envs():
    je = JEnv()
    te = DPCombinedEnv(device="cpu")
    return je, te


def _force_fn(je):
    return jax.jit(jax.vmap(lambda s, a, q, v: je.step(
        s, a, force_state=(q, v))))


@pytest.fixture(scope="module")
def force_step(envs):
    """The JAX env's force-state step, vmapped and compiled once (for
    batches of len(BATCH)): a reset's obs is its obs at the reset state."""
    return _force_fn(envs[0])


def jax_draws(je, keys, count):
    """The draws the JAX ``_reset_state`` makes from each key (its split
    order, with k4 feeding both curriculum coins), as ResetDraws."""
    cfg = je.ENV_CFG
    lw, lg = (int(x) for x in np.asarray(je.motion_lengths)[[WALK, GETUP]])

    def one(key):
        key, k1, k2, k3, k4, k5, k6 = jax.random.split(key, 7)
        k7, _ = jax.random.split(k4)
        kb1, kb2 = jax.random.split(key)
        return (jax.random.bernoulli(k1),
                jax.random.randint(k2, (), 0, lw),
                jax.random.randint(k3, (), 0, lg),
                jax.random.bernoulli(k4, cfg.HANDOFF_RSI_FRAC),
                jax.random.randint(k5, (), 0, max(lg // 4, 1)),
                jax.random.bernoulli(k7, cfg.FACEDOWN_RSI_FRAC),
                jax.random.bernoulli(k6),
                jax.random.bernoulli(kb1, cfg.HANDOFF_BUFFER_FRAC),
                jax.random.randint(kb2, (), 0, max(count, 1)))

    vals = jax.vmap(one)(keys)
    return tce.ResetDraws(*[torch.tensor(np.asarray(v)).to(
        torch.bool if np.asarray(v).dtype == bool else torch.int64)
        for v in vals])


def to_torch_state(js):
    f = lambda x: torch.tensor(np.asarray(x))
    i = lambda x: f(x).to(torch.int64)
    return tce.CombinedEnvState(
        qpos=f(js.qpos), qvel=f(js.qvel), motion_id=i(js.motion_id),
        n_steps=i(js.n_steps), player_action=i(js.player_action),
        episode_length=i(js.episode_length),
        episode_reward=f(js.episode_reward), lam=f(js.lam))


def to_torch_buf(jb):
    f = lambda x: torch.tensor(np.asarray(x))
    return tce.HandoffBuffer(
        qpos=f(jb.qpos), qvel=f(jb.qvel), pa=f(jb.pa).long(),
        motion=f(jb.motion).long(), head=f(jb.head).long(),
        count=f(jb.count).long())


def check_state(js, ts, tol, what):
    for k in ("motion_id", "n_steps", "player_action", "episode_length"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)),
                                      err_msg=f"{what}: {k}")
    for k in ("qpos", "qvel", "episode_reward"):
        e = _err(getattr(js, k), getattr(ts, k).numpy())
        assert e < tol, (what, k, e)


def check_out(jo, to, tol, what):
    for k in ("done", "done_reason", "motion_id"):
        np.testing.assert_array_equal(getattr(to, k).numpy(),
                                      np.asarray(getattr(jo, k)),
                                      err_msg=f"{what}: {k}")
    for k in ("obs", "reward", "imitation_reward", "task_reward"):
        e = _err(getattr(jo, k), getattr(to, k).numpy())
        assert e < tol, (what, k, e)


def check_buf(jb, tb):
    for k in jb._fields:
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)


def test_sizes_clips_and_player_action_obs(envs):
    je, te = envs
    assert (te.obs_size, te.action_size) == (je.obs_size, je.action_size) \
        == (98, 23)
    assert te.lengths == tuple(np.asarray(je.motion_lengths).tolist())
    for k in ("mocap_qpos", "mocap_qvel", "mocap_body_xpos",
              "mocap_geom_xpos"):
        np.testing.assert_allclose(getattr(te, k).numpy(),
                                   np.asarray(getattr(je, k)), atol=1e-6,
                                   err_msg=k)
    # the player-action block on random torso quaternions and commands
    r = np.random.RandomState(0)
    B, n_pa = 6, te.ENV_CFG.MAX_PLAYER_ACTIONS
    quat = r.randn(B, te.model.nbody, 4).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    onehot = np.eye(n_pa, dtype=np.float32)[r.randint(0, n_pa, B)]
    head = r.randn(B, 3).astype(np.float32)
    gs = (r.rand(B, 2) < 0.5).astype(np.float32)

    class Kin:
        def __init__(self, xquat):
            self.xquat = xquat

    class Data:
        def __init__(self, xquat):
            self.kin = Kin(xquat)

    want = jax.vmap(lambda q, o, h, g: jobs.get_player_action_obs(
        je.spec, Data(q), jobs.PlayerActionObs(o, h), g))(
        jnp.asarray(quat), jnp.asarray(onehot), jnp.asarray(head),
        jnp.asarray(gs))
    got = tobs.get_player_action_obs(
        te.spec, Data(torch.tensor(quat)),
        tobs.PlayerActionObs(torch.tensor(onehot), torch.tensor(head)),
        torch.tensor(gs))
    assert got.shape == (B, 2 + n_pa + 2)
    assert _err(want, got.numpy()) < TOL


def test_reset_and_gate_start_match_jax(envs, force_step):
    """Resets under the default config from keys whose first is
    PRNGKey(0), the combined gate's start: the recorded start file equals
    the state of the JAX reset(PRNGKey(0)) (its ``_reset_state``), and
    the port's reset and reset_to give the JAX reset's obs (its obs of the
    kinematic data at the reset state, which the force-state step
    computes)."""
    je, te = envs
    B = len(BATCH)
    keys = jnp.concatenate([jax.random.PRNGKey(0)[None],
                            jax.random.split(jax.random.PRNGKey(5), B - 1)])
    js = jax.jit(jax.vmap(je._reset_state))(keys)
    _, jo = force_step(js, jnp.zeros((B, je.action_size)), js.qpos,
                       js.qvel)
    ts, to = te.reset(B, draws=jax_draws(je, keys, 0))
    check_state(js, ts, TOL, "reset")
    assert _err(jo.obs, to.numpy()) < TOL
    assert ts.lam.shape == (B, te.engine.n_warm_rows)
    np.testing.assert_array_equal(ts.lam.numpy(), np.asarray(js.lam))
    assert {0, 2} <= set(ts.motion_id.tolist())
    start = np.load(START)
    for k in ("motion_id", "n_steps", "player_action", "qpos", "qvel"):
        np.testing.assert_array_equal(start[k], np.asarray(getattr(js, k))[0],
                                      err_msg=k)
    s0, o0 = te.reset_to(*(start[k][None] for k in (
        "qpos", "qvel", "motion_id", "n_steps", "player_action")))
    assert _err(jo.obs[:1], o0.numpy()) < TOL


def _filled_buffers(je, te, cap, n_rows, seed):
    """A JAX and a port handoff buffer holding ``n_rows`` seeded rows."""
    r = np.random.RandomState(seed)
    nq, nv = te.model.nq, te.model.nv
    q = r.randn(n_rows, nq).astype(np.float32)
    v = r.randn(n_rows, nv).astype(np.float32)
    pa = r.randint(0, 2, n_rows)
    mo = r.randint(0, 2, n_rows)
    mask = np.ones(n_rows, bool)
    jb = JEnv.update_handoff_buffer(je.make_handoff_buffer(cap),
                                    jnp.asarray(mask), jnp.asarray(q),
                                    jnp.asarray(v), jnp.asarray(pa),
                                    jnp.asarray(mo))
    return jb, to_torch_buf(jb)


@pytest.mark.parametrize("opts", [False, True], ids=["default", "options"])
def test_reset_state_matches_jax_under_forced_draws(envs, opts):
    """Every reset branch: walk, getup, handoff RSI, facedown RSI, the
    random player action and a buffer draw, with and without rows in the
    buffer."""
    je, te = envs
    cfg = OPTS if opts else {}
    je = _with_cfg(je, JCfg(**cfg))
    te = _with_cfg(te, DPCombinedEnvConfig(**cfg))
    B = 64
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    reset = jax.jit(jax.vmap(je._reset_state, in_axes=(0, None)))
    for n_rows in (0, 5):
        jb, tb = _filled_buffers(je, te, 16, n_rows, 3)
        js = reset(keys, jb)
        ts = te._reset_state(B, handoff_buf=tb,
                             draws=jax_draws(je, keys, n_rows))
        check_state(js, ts, 1e-7, f"reset rows={n_rows}")
        np.testing.assert_array_equal(ts.lam.numpy(), np.asarray(js.lam))
    mid, n = ts.motion_id.numpy(), ts.n_steps.numpy()
    glen = te.lengths[GETUP]
    assert (mid == WALK).any() and (mid == GETUP).any()
    if opts:
        qv = np.abs(ts.qvel.numpy()).max(1)
        rows = tb.qpos.numpy()[:int(tb.count)]
        from_buf = (ts.qpos.numpy()[:, None] == rows[None]).all(-1).any(-1)
        assert from_buf.any() and (n[from_buf] == 1).all()
        assert ((mid == GETUP) & (n == 0) & (qv == 0)).any()   # facedown
        assert ((mid == GETUP) & (n >= glen - glen // 4)).any()  # handoff
        assert (ts.player_action.numpy() == tce.PA_RUN).any()
    else:
        assert (ts.player_action.numpy() == tce.PA_WALK).all()


def test_handoff_buffer_update_and_mask_match_jax(envs):
    je, te = envs
    C, N = 8, 6
    r = np.random.RandomState(7)
    jb = je.make_handoff_buffer(C)
    tb = te.make_handoff_buffer(C)
    check_buf(jb, tb)
    update = jax.jit(JEnv.update_handoff_buffer)
    wrapped = False
    for t in range(6):
        q = r.randn(N, te.model.nq).astype(np.float32)
        v = r.randn(N, te.model.nv).astype(np.float32)
        pa, mo = r.randint(0, 2, N), r.randint(0, 4, N)
        prev = r.randint(0, 4, N)
        done = r.rand(N) < 0.2
        if t in (2, 4):
            prev[:] = GETUP
            mo[:] = r.randint(0, 2, N)
            done[:] = False
        out_j = jce.CombinedStepOut(*([None] * 2), done=jnp.asarray(done),
                                    done_reason=None, imitation_reward=None,
                                    task_reward=None, reward_info=None,
                                    motion_id=jnp.asarray(mo))
        out_t = tce.CombinedStepOut(*([None] * 2), done=torch.tensor(done),
                                    done_reason=None, imitation_reward=None,
                                    task_reward=None, reward_info=None,
                                    motion_id=torch.tensor(mo),
                                    contact_overflow=None)
        mj = JEnv.handoff_capture_mask(jnp.asarray(prev), out_j)
        mt = DPCombinedEnv.handoff_capture_mask(torch.tensor(prev), out_t)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        head0 = int(tb.head)
        jb = update(jb, mj, jnp.asarray(q), jnp.asarray(v), jnp.asarray(pa),
                    jnp.asarray(mo))
        tb = DPCombinedEnv.update_handoff_buffer(
            tb, mt, torch.tensor(q), torch.tensor(v), torch.tensor(pa),
            torch.tensor(mo))
        check_buf(jb, tb)
        wrapped |= head0 + int(mt.sum()) > C
    assert wrapped and int(tb.count) == C
    # one call capturing more rows than the capacity: the last C rows
    # captured are the ones kept, in ring order from head (the JAX
    # package's scatter on the CPU keeps the last write too)
    q = r.randn(C + 3, te.model.nq).astype(np.float32)
    v = r.randn(C + 3, te.model.nv).astype(np.float32)
    mask = np.ones(C + 3, bool)
    mask[4] = False
    args = (q, v, np.arange(C + 3) % 2, np.zeros(C + 3, np.int64))
    head0 = int(tb.head)
    tb = DPCombinedEnv.update_handoff_buffer(
        tb, torch.tensor(mask), *(torch.tensor(a) for a in args))
    jb = update(jb, jnp.asarray(mask), *(jnp.asarray(a) for a in args))
    check_buf(jb, tb)
    kept = np.flatnonzero(mask)[-C:]
    slots = (head0 + np.arange(len(np.flatnonzero(mask)))[-C:]) % C
    np.testing.assert_array_equal(tb.qpos.numpy()[slots], q[kept])
    assert int(tb.head) == (head0 + C + 2) % C and int(tb.count) == C


def _roll(qpos, deg):
    """Root quaternion (w, x, y, z) turned by ``deg`` about world x."""
    a = np.deg2rad(deg) / 2
    w1, x1 = np.cos(a), np.sin(a)
    w2, x2, y2, z2 = qpos[..., 3:7].T
    out = qpos.copy()
    out[..., 3:7] = np.stack([w1 * w2 - x1 * x2, w1 * x2 + x1 * w2,
                              w1 * y2 - x1 * z2, w1 * z2 + x1 * y2], -1)
    return out.astype(np.float32)


# (motion, n_steps, episode_length, pose, tipped): every transition
BATCH = [
    (GETUP, "end", 40, ("getup", "end"), False),   # timer -> RUN (WALK)
    (TO_GETUP, 179, 300, ("walk", 10), False),     # timer -> GETUP
    (TO_GETUP, 5, 300, ("getup", 1), False),       # pose reached -> GETUP
    (WALK, 200, 250, ("walk", 30), True),          # fallen, amnesty
    (WALK, 100, 100, ("walk", 40), True),          # fallen, no amnesty
    (RUN, 20, 2000, ("run", 20), False),           # MAX_EP_LENGTH
    (WALK, 170, 20, ("walk", 50), False),
    (RUN, 30, 30, ("run", 5), False),
    (GETUP, 100, 100, ("getup", 100), False),
    (TO_GETUP, 50, 60, ("walk", 60), True),
]


def _batch_state(je, te, keys):
    clips = {"walk": je.clips[WALK], "run": je.clips[RUN],
             "getup": je.clips[GETUP]}
    qpos, qvel = [], []
    for mid, n, _, (clip, frame), tip in BATCH:
        c = clips[clip]
        f = len(c) - 1 if frame == "end" else frame
        q = np.asarray(c.qpos[f], np.float32)
        qpos.append(_roll(q, 75.0) if tip else q)
        qvel.append(np.asarray(c.qvel[f], np.float32))
    B = len(BATCH)
    glen = te.lengths[GETUP]
    i32 = lambda x: jnp.asarray(np.asarray(x), jnp.int32)
    return jce.CombinedEnvState(
        qpos=jnp.asarray(np.stack(qpos)), qvel=jnp.asarray(np.stack(qvel)),
        motion_id=i32([b[0] for b in BATCH]),
        n_steps=i32([glen - 1 if b[1] == "end" else b[1] for b in BATCH]),
        player_action=i32(np.arange(B) % 2),
        episode_length=i32([b[2] for b in BATCH]),
        episode_reward=jnp.asarray(np.linspace(0, 3, B), jnp.float32),
        key=keys, lam=jnp.tile(je.engine.empty_lam()[None], (B, 1)))


def test_steps_match_jax_on_every_transition(envs, force_step):
    """One batch through physics step_auto_reset (handoff buffer armed),
    a second physics step carrying the warm start across the motion
    switches, and a force-state step (tipped poses, a NaN velocity)
    followed by a physics step that starts from its empty warm start.
    """
    je0, te0 = envs
    je = _with_cfg(je0, JCfg(**OPTS))
    te = _with_cfg(te0, DPCombinedEnvConfig(**OPTS))
    B = len(BATCH)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    js0 = _batch_state(je, te, keys)
    ts0 = to_torch_state(js0)
    jb, tb = _filled_buffers(je, te, 16, 5, 4)
    r = np.random.RandomState(5)
    acts = [(r.uniform(-1, 1, (B, te.action_size)) * 0.3).astype(np.float32)
            for _ in range(3)]

    sar = jax.jit(jax.vmap(je.step_auto_reset, in_axes=(0, 0, None)))

    def phys(js, ts, a, what):
        # the port draws what the JAX env draws from split(state.key)
        subs = jax.vmap(lambda k: jax.random.split(k)[1])(js.key)
        js1, jo = sar(js, jnp.asarray(a), jb)
        ts1, to = te.step_auto_reset(ts, torch.tensor(a), handoff_buf=tb,
                                     draws=jax_draws(je, subs, 5))
        check_out(jo, to, TOL_STEP, what)
        check_state(js1, ts1, TOL_STEP, what)
        return js1, ts1, to

    js1, ts1, to1 = phys(js0, ts0, acts[0], "physics step 1")
    mid0 = np.asarray(js0.motion_id)
    mid1 = to1.motion_id.numpy()
    reason = to1.done_reason.numpy()
    assert mid1[0] == RUN and mid1[1] == GETUP
    assert mid1[3] == TO_GETUP and not to1.done[3]
    assert reason[4] == tce.DONE_FALLEN_NO_AMNESTY and mid1[4] == TO_GETUP
    assert reason[5] == 5                         # DONE_MAX_EP_LEN
    assert (mid1[6:9] == mid0[6:9]).all()
    # the done envs restarted from the forced reset draws
    assert int(ts1.episode_length[4]) == int(ts1.episode_length[5]) == 0
    phys(js1, ts1, acts[1], "physics step 2")

    # force-state step: tipped locomotion, the to_getup pose reached, a
    # NaN velocity; the getup timer with and without the flag
    fq = np.asarray(js0.qpos).copy()
    fv = np.asarray(js0.qvel).copy()
    fv[7, 3] = np.nan
    flag_j = copy.copy(je0)
    flag_j.getup_timeout_to_walk = True
    flag_t = copy.copy(te0)
    flag_t.getup_timeout_to_walk = True
    a = jnp.asarray(acts[2])
    for fn, env_t, first in ((force_step, te0, RUN),
                             (_force_fn(flag_j), flag_t, WALK)):
        jf, jo = fn(js0, a, jnp.asarray(fq), jnp.asarray(fv))
        tf, to = env_t.step(ts0, torch.tensor(acts[2]),
                            force_state=(torch.tensor(fq), torch.tensor(fv)))
        check_out(jo, to, TOL, "force step")
        check_state(jf, tf, TOL, "force step")
        np.testing.assert_array_equal(tf.lam.numpy(), np.asarray(jf.lam))
        assert int(to.motion_id[0]) == first
        assert int(to.motion_id[2]) == GETUP      # to_getup pose reached
        assert int(to.motion_id[3]) == TO_GETUP and not bool(to.done[3])
        assert int(to.done_reason[7]) == 7 and bool(to.done[7])  # OBS_OOB
        assert torch.isfinite(tf.qvel[7]).all() and tf.qvel[7, 3] == 0
        assert (to.obs[7] == 0).all() and to.reward[7] == 0
    assert int(to.done_reason[4]) == tce.DONE_FALLEN_NO_AMNESTY
    # a physics step from the force step's empty warm start
    phys(jf._replace(key=keys), tf, acts[1], "physics after force")
