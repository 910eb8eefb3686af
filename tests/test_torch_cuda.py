"""Card-only tests of the PyTorch/CUDA port, plus the device rules that
hold without a card.

This file imports no JAX, so it also runs on a machine that has a CUDA
device and no JAX: ``python -m pytest tests/test_torch_cuda.py -m gpu``.
Tests marked ``gpu`` decide in a fixture whether a card is present and
skip without one.
"""
import numpy as np
import pytest
import torch

from deepmimic_mujoco_tpu_torch.envs import DPEnv
from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs
from deepmimic_mujoco_tpu_torch.physics import solver
from deepmimic_mujoco_tpu_torch.rl.ppo import PPO, PPOConfig
from deepmimic_mujoco_tpu_torch.rl.sac import SAC, SACConfig
from deepmimic_mujoco_tpu_torch.utils.device import resolve_device

TOL_KERNEL = 2e-4   # max|d|/scale, tests/test_fused_solve.py
TOL_STEP = 5e-3
H3D, G1 = (34, 16, 28), (43, 24, 37)


def _mk(seed, B, nv, K, L):
    """Random SPD systems (tests/test_fused_solve.py:_mk, batched) with a
    nonzero warm start, J^T laid out (B, nv, n) for the kernel."""
    n = 3 * K + L
    r = np.random.RandomState(seed)
    G = r.randn(B, nv, nv)
    M = G @ G.transpose(0, 2, 1) + nv * np.eye(nv)
    JT = (r.randn(B, n, nv) * (r.rand(B, n, 1) < 0.8)).transpose(0, 2, 1)
    qf = r.randn(B, nv) * 10
    aref = r.randn(B, n)
    imp = np.clip(r.rand(B, n), 0.05, 0.95)
    act_c = r.rand(B, K) < 0.5
    active = np.concatenate([act_c, act_c, act_c, r.rand(B, L) < 0.3], 1)
    mu = np.full((B, K), 1.0)
    lam0 = r.randn(B, n)
    return [np.ascontiguousarray(x, np.float32)
            for x in (M, JT, qf, aref, imp, active, mu, lam0)]


def _mk_parts(seed, B, nv, K, L):
    """Contact-Jacobian parts like the engine's (orthonormal frames,
    signed 0/1 dof masks, L distinct limited dofs): ([cd_lin, cd_ang,
    frame, rpos, w, sign_l], ld_idx)."""
    r = np.random.RandomState(seed)
    frame, _ = np.linalg.qr(r.randn(B, K, 3, 3))
    parts = [r.randn(B, nv, 3), r.randn(B, nv, 3), frame,
             r.randn(B, K, 3) * 0.3, r.choice([-1.0, 0.0, 1.0], (B, K, nv)),
             np.where(r.rand(B, L) < 0.5, 1.0, -1.0)]
    ld_idx = tuple(int(i) for i in np.sort(r.choice(nv, L, replace=False)))
    return [np.ascontiguousarray(x, np.float32) for x in parts], ld_idx


def _err(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / max(float(a.abs().max()), 1.0))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dims,B,pyramidal", [(H3D, 2048, False),
                                              (H3D, 1000, True),
                                              (G1, 1000, True)])
def test_kernel_matches_plain_on_card(cuda_device, dims, B, pyramidal):
    nv, K, L = dims
    args = [torch.tensor(a, device=cuda_device)
            for a in _mk(3, B, nv, K, L)]
    before = fs.fused_solve.launches
    got = fs.fused_solve(*args, K=K, L=L, iterations=50, pyramidal=pyramidal)
    torch.cuda.synchronize()
    assert fs.fused_solve.launches == before + 1
    want = fs.fused_solve_plain(*args, K=K, L=L, iterations=50,
                                pyramidal=pyramidal)
    errs = [_err(a, b) for a, b in zip(want, got)]
    assert max(errs) < TOL_KERNEL, errs


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 1000, 2048])
@pytest.mark.parametrize("dims", [H3D, G1], ids=["h3d", "g1"])
def test_parts_kernel_matches_plain_on_card(cuda_device, dims, B):
    """The parts entry (J^T built inside the kernel) against build_jt +
    the plain version; a ragged B leaves the last block part-filled."""
    nv, K, L = dims
    M, _, *vectors = (torch.tensor(a, device=cuda_device)
                      for a in _mk(5, B, nv, K, L))
    parts, ld_idx = _mk_parts(6, B, nv, K, L)
    parts = [torch.tensor(a, device=cuda_device) for a in parts]
    kw = dict(K=K, L=L, iterations=50, pyramidal=B == 1000)
    before = fs.fused_solve.launches
    got = fs.fused_solve_parts(M, *parts, *vectors, ld_idx=ld_idx, **kw)
    torch.cuda.synchronize()
    assert fs.fused_solve.launches == before + 1
    want = fs.fused_solve_plain(M, fs.build_jt(*parts, ld_idx), *vectors,
                                **kw)
    errs = [_err(a, b) for a, b in zip(want, got)]
    assert max(errs) < TOL_KERNEL, errs


@pytest.mark.gpu
@pytest.mark.parametrize("K", [26, 48, 64, 128])
def test_shared_plan_matches_plain_on_card(cuda_device, K):
    """The shared-memory plan (G1 with more contact slots than a register
    plan holds): both entries, both cones, against the plain version,
    and its phase clocks."""
    nv, L = 43, 37
    B = 333
    assert fs.launch_plan(nv, 3 * K + L, K).shared
    M, JT, *vectors = (torch.tensor(a, device=cuda_device)
                       for a in _mk(11 + K, B, nv, K, L))
    parts, ld_idx = _mk_parts(12 + K, B, nv, K, L)
    parts = [torch.tensor(a, device=cuda_device) for a in parts]
    for pyramidal in (False, True):
        kw = dict(K=K, L=L, iterations=50, pyramidal=pyramidal)
        before = fs.fused_solve.launches
        got = fs.fused_solve(M, JT, *vectors, **kw)
        got_p = fs.fused_solve_parts(M, *parts, *vectors, ld_idx=ld_idx,
                                     **kw)
        torch.cuda.synchronize()
        assert fs.fused_solve.launches == before + 2
        for want, have in (
                (fs.fused_solve_plain(M, JT, *vectors, **kw), got),
                (fs.fused_solve_plain(M, fs.build_jt(*parts, ld_idx),
                                      *vectors, **kw), got_p)):
            errs = [_err(a, b) for a, b in zip(want, have)]
            assert max(errs) < TOL_KERNEL, errs
    clocks = fs.phase_cycles(M, *parts, *vectors, K=K, L=L, ld_idx=ld_idx,
                             iterations=50)
    torch.cuda.synchronize()
    assert bool((clocks[:, 1:] > clocks[:, :-1]).all())


@pytest.mark.gpu
def test_phase_cycles_on_card(cuda_device):
    nv, K, L = H3D
    M, _, *vectors = (torch.tensor(a, device=cuda_device)
                      for a in _mk(7, 64, nv, K, L))
    parts, ld_idx = _mk_parts(8, 64, nv, K, L)
    parts = [torch.tensor(a, device=cuda_device) for a in parts]
    before = fs.fused_solve.launches
    clocks = fs.phase_cycles(M, *parts, *vectors, K=K, L=L, ld_idx=ld_idx,
                             iterations=50)
    torch.cuda.synchronize()
    assert fs.fused_solve.launches == before
    assert clocks.shape == (64, len(fs.PHASES) + 1)
    assert bool((clocks[:, 1:] > clocks[:, :-1]).all())


@pytest.mark.gpu
def test_launches_counted_by_thread(cuda_device):
    """Each launch adds one to the total and one to the launching
    thread's count, so a worker's launches do not show in another
    thread's."""
    import threading

    nv, K, L = H3D
    M, _, *vectors = (torch.tensor(a, device=cuda_device)
                      for a in _mk(9, 8, nv, K, L))
    parts, ld_idx = _mk_parts(10, 8, nv, K, L)
    parts = [torch.tensor(a, device=cuda_device) for a in parts]
    call = lambda: fs.fused_solve_parts(M, *parts, *vectors, K=K, L=L,
                                        ld_idx=ld_idx, iterations=50)
    by_thread = fs.fused_solve.launches_by_thread
    counted = lambda: by_thread.get(threading.get_ident(), 0)
    in_worker = []

    def work():
        before = counted()
        for _ in range(3):
            call()
        in_worker.append(counted() - before)

    total, mine = fs.fused_solve.launches, counted()
    worker = threading.Thread(target=work)
    worker.start()
    worker.join()
    call()
    torch.cuda.synchronize()
    assert fs.fused_solve.launches == total + 4
    assert counted() == mine + 1
    assert in_worker == [3]


@pytest.mark.gpu
def test_env_step_on_card_matches_cpu(cuda_device):
    """One DPEnv step on the card launches the kernel once and agrees
    with the CPU path on the same states and actions."""
    frames = torch.tensor([0, 15, 30, 45, 60, 70])
    act = torch.tensor(np.random.RandomState(0).uniform(
        -1, 1, (len(frames), 28)).astype(np.float32)) * 40
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        env = DPEnv(motion="walk", robot="humanoid3d", device=dev)
        state, _ = env.reset(len(frames), idx_init=frames.to(dev))
        before = fs.fused_solve.launches
        state, out = env.step(state, act.to(dev))
        outs.append((state, out, fs.fused_solve.launches - before))
    (sg, og, ng), (sc, oc, nc) = outs
    assert (ng, nc) == (1, 0)
    for a, b in ((sc.qpos, sg.qpos), (sc.qvel, sg.qvel), (oc.obs, og.obs),
                 (oc.reward, og.reward)):
        assert _err(a, b) < TOL_STEP
    assert torch.equal(oc.done, og.done.cpu())


@pytest.mark.gpu
def test_g1_parts_kernel_matches_plain_on_main_path_inputs(cuda_device):
    """The G1 plan (4 x 16 threads) on the inputs a G1 walk step gives
    the solve, warm-started from the step before."""
    env = DPEnv(motion="walk", robot="unitree_g1", device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    state, _ = env.reset(256, generator=g)
    act = torch.zeros(256, env.action_size, device=cuda_device)
    state, _ = env.step(state, act)
    captured = []
    entry = solver.fused_solve_parts

    def record(*args, **kw):
        captured.append(([a.clone() for a in args], dict(kw)))
        return entry(*args, **kw)

    solver.fused_solve_parts = record
    try:
        env.step(state, act)
    finally:
        solver.fused_solve_parts = entry
    args, kw = captured[0]
    assert (kw["K"], kw["L"]) == (24, 37)
    assert fs.launch_plan(43, 109, 24)[:2] == (4, 16)
    before = fs.fused_solve.launches
    got = fs.fused_solve_parts(*args, **kw)
    torch.cuda.synchronize()
    assert fs.fused_solve.launches == before + 1
    plain_kw = {k: v for k, v in kw.items() if k != "ld_idx"}
    want = fs.fused_solve_plain(args[0], fs.build_jt(*args[1:7],
                                                     kw["ld_idx"]),
                                *args[7:], **plain_kw)
    errs = [_err(a, b) for a, b in zip(want, got)]
    assert max(errs) < TOL_KERNEL, errs


@pytest.mark.gpu
def test_engine_on_card_refuses_what_no_plan_holds(cuda_device):
    """The G1 engine on the card takes 128 slots (the shared-memory
    plan) and refuses just past what one block's shared memory holds,
    naming that limit."""
    env = DPEnv(motion="walk", robot="unitree_g1", max_contacts=128,
                device=cuda_device)
    assert env.engine.solve_plan.shared
    with pytest.raises(ValueError, match="max_contacts=384"):
        DPEnv(motion="walk", robot="unitree_g1", max_contacts=385,
              device=cuda_device)


class _ForcedFramesEnv(DPEnv):
    """RSI reset frames drawn on the CPU from the env's own generator, so
    the card and the CPU path reset to the same frames."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._cpu_gen = torch.Generator().manual_seed(11)

    def _draw_frames(self, n, generator):
        return torch.randint(0, self.mocap_data_len, (n,),
                             generator=self._cpu_gen).to(self.device)

    def step_auto_reset(self, *args, **kw):
        # a host draw: a captured step would replay its first draw
        return self.step_auto_reset_eager(*args, **kw)


class _ForcedPPO(PPO):
    """Action noise and permutations drawn on the CPU from fixed seeds."""

    def init(self, seed=0):
        self._g = torch.Generator().manual_seed(seed + 100)
        return super().init(seed)

    def draw_noise(self, ts, mean):
        return torch.randn(mean.shape, generator=self._g).to(mean.device)

    def draw_perm(self, ts, n):
        return torch.randperm(n, generator=self._g).to(self.device)


@pytest.mark.gpu
def test_ppo_iteration_on_card_matches_cpu(cuda_device):
    """One PPO iteration on G1 walk envs on the card (the kernel on the
    path) against the CPU path, with the same draws."""
    cfg = PPOConfig(n_envs=8, horizon=4, minibatch_size=16, epochs=2,
                    net_arch=(16,), total_timesteps=32)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        env = _ForcedFramesEnv(motion="walk", robot="unitree_g1", device=dev)
        ppo = _ForcedPPO(env, cfg)
        ts = ppo.init(seed=2)
        before = fs.fused_solve.launches
        ts, st = ppo.train_iter(ts)
        out[dev.type] = (ts, st, fs.fused_solve.launches - before)
    (tg, sg, ng), (tc, sc, nc) = out["cuda"], out["cpu"]
    assert (ng, nc) == (cfg.horizon, 0)
    for k in ("pg_loss", "v_loss", "entropy", "approx_kl", "mean_reward"):
        a, b = float(getattr(sc, k)), float(getattr(sg, k))
        assert abs(a - b) <= TOL_STEP * max(abs(a), 1e-3), (k, a, b)
    for (k, a), b in zip(tc.net.state_dict().items(),
                         tg.net.state_dict().values()):
        assert _err(a, b) < TOL_STEP, k


@pytest.mark.gpu
def test_combined_step_on_card_matches_cpu(cuda_device):
    """step_auto_reset of the combined env on the card (handoff buffer
    armed, every reset option on, forced draws) against the CPU path:
    one launch per step, motion ids, steps and dones equal, obs, rewards
    and states within the step tolerance, the buffer update equal."""
    from deepmimic_mujoco_tpu_torch.envs import (
        DPCombinedEnv, DPCombinedEnvConfig,
    )

    cfg = DPCombinedEnvConfig(HANDOFF_RSI_FRAC=0.3, RSI_RANDOM_PA=True,
                              HANDOFF_BUFFER_FRAC=0.5, FACEDOWN_RSI_FRAC=0.2)
    n = 16
    envs = {d: DPCombinedEnv(cfg=cfg, device=d)
            for d in (cuda_device, torch.device("cpu"))}
    cpu = envs[torch.device("cpu")]
    g = torch.Generator().manual_seed(3)
    buf = cpu.make_handoff_buffer(32)
    buf = cpu.update_handoff_buffer(
        buf, torch.ones(4, dtype=torch.bool), cpu.mocap_qpos[1, :4],
        cpu.mocap_qvel[1, :4], torch.ones(4, dtype=torch.int64),
        torch.full((4,), 1))
    draws = [cpu.draw_reset(n, g, buf) for _ in range(3)]
    acts = [torch.rand(n, cpu.action_size, generator=g) * 0.6 - 0.3
            for _ in range(2)]
    outs = {}
    for dev, env in envs.items():
        mv = lambda t: type(t)(*[x.to(dev) for x in t])
        b = mv(buf)
        state, _ = env.reset(n, draws=mv(draws[0]))
        before = fs.fused_solve.launches
        for i in range(2):
            prev = state.motion_id
            pa = state.player_action
            state, out = env.step_auto_reset(state, acts[i].to(dev),
                                             handoff_buf=b,
                                             draws=mv(draws[i + 1]))
            b = env.update_handoff_buffer(b, env.handoff_capture_mask(
                prev, out), state.qpos, state.qvel, pa, out.motion_id)
        outs[dev.type] = (state, out, b, fs.fused_solve.launches - before)
    (sg, og, bg, ng), (sc, oc, bc, nc) = outs["cuda"], outs["cpu"]
    assert (ng, nc) == (2, 0)
    for k in ("motion_id", "n_steps", "player_action", "episode_length"):
        assert torch.equal(getattr(sc, k), getattr(sg, k).cpu()), k
    for k in ("done", "done_reason", "motion_id"):
        assert torch.equal(getattr(oc, k), getattr(og, k).cpu()), k
    for a, b in ((sc.qpos, sg.qpos), (sc.qvel, sg.qvel), (oc.obs, og.obs),
                 (oc.reward, og.reward)):
        assert _err(a, b) < TOL_STEP
    assert torch.equal(bc.count, bg.count.cpu())
    assert torch.equal(bc.head, bg.head.cpu())


@pytest.mark.gpu
def test_rk4_step_on_card_matches_cpu(cuda_device):
    """An RK4 DPEnv step on the card: four launches (cold-started
    stages), within the step tolerance of the CPU path."""
    from deepmimic_mujoco_tpu_torch.models.physics_model import RK4

    frames = torch.tensor([0, 15, 30, 45, 60, 70])
    act = torch.tensor(np.random.RandomState(1).uniform(
        -1, 1, (len(frames), 28)).astype(np.float32)) * 0.5
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        env = DPEnv(motion="walk", robot="humanoid3d", integrator=RK4,
                    device=dev)
        state, _ = env.reset(len(frames), idx_init=frames.to(dev))
        before = fs.fused_solve.launches
        state, out = env.step(state, act.to(dev))
        outs.append((state, out, fs.fused_solve.launches - before))
    (sg, og, ng), (sc, oc, nc) = outs
    assert (ng, nc) == (4, 0)
    for a, b in ((sc.qpos, sg.qpos), (sc.qvel, sg.qvel), (oc.obs, og.obs),
                 (oc.reward, og.reward)):
        assert _err(a, b) < TOL_STEP
    assert torch.equal(oc.done, og.done.cpu())
    assert torch.equal(sc.lam, sg.lam.cpu())


@pytest.mark.gpu
def test_cli_trains_combined_env_on_card(cuda_device, tmp_path,
                                         monkeypatch):
    """One tiny training iteration of the CLI's default (combined) env on
    the card, with the handoff buffer armed."""
    import functools
    import glob
    import json

    from deepmimic_mujoco_tpu_torch.rl import eval as rl_eval
    from deepmimic_mujoco_tpu_torch.rl.train import main

    monkeypatch.setattr(rl_eval, "eval_dashboard_rollout", functools.partial(
        rl_eval.eval_dashboard_rollout, max_steps=8))
    ts = main(["card", "--n-envs", "8", "--horizon", "4", "--minibatch",
               "16", "--epochs", "1", "--total", "32", "--no-wandb",
               "--no-render", "--out", str(tmp_path), "--handoff-buffer",
               "0.5", "--facedown-rsi", "0.2"])
    assert ts.global_step == 32 and ts.last_obs.is_cuda
    assert ts.handoff_buf.qpos.is_cuda
    rows = [json.loads(line) for line in open(glob.glob(
        str(tmp_path / "*_metrics.jsonl"))[0])]
    it = [r for r in rows if "pg_loss" in r]
    assert len(it) == 1 and "handoff_count" in it[0]
    assert np.isfinite(it[0]["pg_loss"])


class _ForcedSAC(SAC):
    """SAC's four draws made on the CPU from a fixed seed."""

    def init(self, seed=0, init_actor=None):
        self._g = torch.Generator().manual_seed(seed + 100)
        return super().init(seed, init_actor)

    def _normal(self, gen, like):
        return torch.randn(like.shape, generator=self._g).to(like.device)

    def draw_idx(self, s, valid):
        return torch.randint(0, valid, (self.cfg.batch_size,),
                             generator=self._g).to(self.device)


@pytest.mark.gpu
def test_sac_iteration_on_card_matches_cpu(cuda_device):
    """One SAC iteration on humanoid3d walk envs on the card (one launch
    per collect step) against the CPU path, with the same draws: the
    buffer, the losses and the nets within the step tolerance."""
    cfg = SACConfig(n_envs=8, buffer_size=64, batch_size=16,
                    steps_per_iter=4, updates_per_iter=3, net_arch=(32, 16))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        env = _ForcedFramesEnv(motion="walk", robot="humanoid3d", device=dev)
        sac = _ForcedSAC(env, cfg)
        s = sac.init(seed=2)
        before = fs.fused_solve.launches
        s, st = sac.train_iter(s)
        out[dev.type] = (s, st, fs.fused_solve.launches - before)
    (sg, stg, ng), (sc, stc, nc) = out["cuda"], out["cpu"]
    assert (ng, nc) == (cfg.steps_per_iter, 0)
    assert sg.buf_pos == sc.buf_pos == 32 and sg.buffer["obs"].is_cuda
    for k in ("obs", "action", "reward", "next_obs"):
        assert _err(sc.buffer[k], sg.buffer[k]) < TOL_STEP, k
    assert torch.equal(sc.buffer["done"], sg.buffer["done"].cpu())
    for k in stc._fields:
        a, b = float(getattr(stc, k)), float(getattr(stg, k))
        assert abs(a - b) <= TOL_STEP * max(abs(a), 1e-3), (k, a, b)
    for net in ("actor", "critic", "target_critic"):
        for (k, a), b in zip(getattr(sc, net).state_dict().items(),
                             getattr(sg, net).state_dict().values()):
            assert _err(a, b) < TOL_STEP, (net, k)


@pytest.mark.gpu
def test_gym_env_step_on_card_matches_cpu(cuda_device):
    """GymDPEnv on the card (one launch a step) against the CPU path."""
    from deepmimic_mujoco_tpu_torch.envs.gym_wrapper import GymDPEnv

    acts = np.random.RandomState(2).uniform(-0.3, 0.3, (3, 28))
    res = {}
    for dev in (cuda_device, torch.device("cpu")):
        g = GymDPEnv(motion="walk", robot="humanoid3d", device=dev)
        obs = [g.reset_model(idx_init=20)]
        before = fs.fused_solve.launches
        steps = [g.step(a) for a in acts]
        res[dev.type] = (obs + [s[0] for s in steps], [s[1] for s in steps],
                         [s[2] for s in steps], fs.fused_solve.launches
                         - before)
    (og, rg, dg, ng), (oc, rc, dc, nc) = res["cuda"], res["cpu"]
    assert (ng, nc) == (len(acts), 0)
    for a, b in zip(oc, og):
        assert _err(torch.tensor(a), torch.tensor(b)) < TOL_STEP
    assert np.allclose(rc, rg, rtol=0, atol=TOL_STEP) and dc == dg


@pytest.mark.gpu
def test_stage_breakdown_on_card(cuda_device):
    """profiling.stage_breakdown at batch 256 on the card: the eager
    step's spans, ``env.step`` first and every stage after it, the
    kernel launched once in the warm-up and once in each of the 8
    steps."""
    from deepmimic_mujoco_tpu_torch.tools.profiling import stage_breakdown

    env = DPEnv(motion="walk", robot="humanoid3d", device=cuda_device)
    before = fs.fused_solve.launches
    rows = stage_breakdown(env, batch=256)
    assert fs.fused_solve.launches - before == 9
    assert rows[0][0] == "env.step"
    assert {"env.physics", "engine.kinematics", "engine.collision",
            "engine.dynamics", "engine.constraints", "engine.solve",
            "engine.integrate", "env.obs", "env.reward", "env.done",
            "env.reset"} == {name for name, _ in rows[1:]}
    assert all(ms > 0 for _, ms in rows)


@pytest.mark.gpu
@pytest.mark.parametrize("robot", ["humanoid3d", "unitree_g1"])
def test_render_state_on_card_matches_cpu(cuda_device, robot):
    """render_state with FK on the card against FK on the CPU path (the
    same ray tracer): at most 0.1% of the pixels differ."""
    from deepmimic_mujoco_tpu_torch.mocap import load_clip
    from deepmimic_mujoco_tpu_torch.models import assets, load_model
    from deepmimic_mujoco_tpu_torch.tools.render import render_state

    m = load_model(assets.xml_path(robot))
    q = (m.key_qpos[0] if robot == "unitree_g1" else load_clip(
        assets.mocap_path(robot, "walk"), m).qpos[10])
    card, cpu = (render_state(m, q, width=320, height=240, device=d)
                 for d in (cuda_device, "cpu"))
    assert card.shape == (240, 320, 3) and card.std() > 20
    assert (card != cpu).any(-1).mean() <= 1e-3


@pytest.mark.gpu
def test_cli_renders_dashboard_on_card(cuda_device, tmp_path, monkeypatch):
    """One tiny training iteration of the CLI without --no-render on the
    card: the first evaluation writes its dashboard video and both
    plots. Needs cv2 and matplotlib (the CLI checks for both)."""
    import functools
    import glob
    import os

    pytest.importorskip("cv2")
    pytest.importorskip("matplotlib")
    from deepmimic_mujoco_tpu_torch.rl import eval as rl_eval
    from deepmimic_mujoco_tpu_torch.rl.train import main

    monkeypatch.setattr(rl_eval, "eval_dashboard_rollout", functools.partial(
        rl_eval.eval_dashboard_rollout, max_steps=8))
    ts = main(["card", "--env", "deep_mimic_mujoco", "--robot", "humanoid3d",
               "--n-envs", "8", "--horizon", "4", "--minibatch", "16",
               "--epochs", "1", "--total", "32", "--no-wandb", "--out",
               str(tmp_path)])
    assert ts.global_step == 32 and ts.last_obs.is_cuda
    (videos,) = glob.glob(str(tmp_path / "*_videos"))
    assert glob.glob(os.path.join(videos, "global_step_*.mp4"))
    for name in ("rew_plot.png", "len_plot.png"):
        assert os.path.getsize(os.path.join(videos, name)) > 0


@pytest.mark.gpu
def test_world1_nccl_on_card_matches_unsharded(cuda_device, tmp_path):
    """One PPO iteration of G1 walk envs over a one-rank NCCL group on the
    card (``parallel.shard_train_state``, every collective run) against
    the unsharded iteration on the card from the same seed: stats and
    params as tests/test_multichip.py holds them, one launch a step."""
    from deepmimic_mujoco_tpu_torch.parallel import mesh as mesh_lib
    from deepmimic_mujoco_tpu_torch.parallel import shard_train_state

    cfg = PPOConfig(n_envs=8, horizon=4, minibatch_size=16, epochs=2,
                    net_arch=(16,), total_timesteps=32)
    ppo = PPO(DPEnv(motion="walk", robot="unitree_g1", device=cuda_device),
              cfg)
    ts, st = ppo.train_iter(ppo.init(seed=2))
    mesh = mesh_lib.init_group(0, 1, f"file://{tmp_path}/store",
                               device="cuda")
    try:
        assert mesh.backend == "nccl"
        ts1 = shard_train_state(ppo.init(seed=2), mesh)
        before = fs.fused_solve.launches
        ts1, st1 = ppo.train_iter(ts1)
        launches = fs.fused_solve.launches - before
    finally:
        torch.distributed.destroy_process_group()
    assert launches == cfg.horizon
    n_mb = cfg.n_envs * cfg.horizon // cfg.minibatch_size
    assert mesh.counts["all_reduce"] == 2 + cfg.epochs * (n_mb + 1)
    for k in ("pg_loss", "v_loss", "entropy", "approx_kl", "mean_reward"):
        a, b = float(getattr(st, k)), float(getattr(st1, k))
        assert abs(a - b) <= 1e-4 * max(1.0, abs(a)), (k, a, b)
    for (k, a), b in zip(ts.net.state_dict().items(),
                         ts1.net.state_dict().values()):
        scale = max(float(a.abs().max()), 1e-3)
        assert float((a - b).abs().max()) / scale < 5e-4, k


# ---- the env step replayed as CUDA graphs (envs/graphs.py) ------------

GRAPH_STEPS = 64


@pytest.fixture(scope="module")
def graph_envs():
    """The envs the graph tests step on the card, built once: the
    benchmark's three cells' (h3d walk, G1 getup at 128 slots, the
    training CLI's combined env with its handoff buffer)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deepmimic_mujoco_tpu_torch.envs import (
        DPCombinedEnv, DPCombinedEnvConfig,
    )

    dev = torch.device("cuda")
    return {
        "h3d_walk": DPEnv(motion="walk", robot="humanoid3d", device=dev),
        "g1_getup_k128": DPEnv(motion="getup_facedown_slow_FSI",
                               robot="unitree_g1", max_contacts=128,
                               device=dev),
        "combined": DPCombinedEnv(cfg=DPCombinedEnvConfig(
            HANDOFF_BUFFER_FRAC=0.25, FACEDOWN_RSI_FRAC=0.1), device=dev)}


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [y for v in x for y in _leaves(v)]
    return []


def _same(a, b):
    """Bit for bit (floats compared as their bits, so NaN equals NaN)."""
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(bits(a), bits(b)))


def _graph_rollout(env, eager, steps=GRAPH_STEPS, n_envs=2048, seed=7):
    """``steps`` steps of ``step_auto_reset`` (or of its eager method)
    from one seeded reset under seeded actions, the combined env's
    handoff buffer updated as PPO.rollout updates it: every step's
    (state, out[, buffer]) and the generator's next draw."""
    dev = env.device
    g = torch.Generator(device=dev).manual_seed(seed)
    g_act = torch.Generator(device=dev).manual_seed(seed + 1)
    combined = hasattr(env, "make_handoff_buffer")
    step = env.step_auto_reset_eager if eager else env.step_auto_reset
    steps_out = []
    with torch.no_grad():
        state, _ = env.reset(n_envs, generator=g)
        buf = env.make_handoff_buffer() if combined else None
        for _ in range(steps):
            a = torch.rand(n_envs, env.action_size, generator=g_act,
                           device=dev) * 2 - 1
            if not combined:
                state, out = step(state, a, g)
                steps_out.append((state, out))
                continue
            prev, pa = state.motion_id, state.player_action
            state, out = step(state, a, g, handoff_buf=buf)
            buf = env.update_handoff_buffer(
                buf, env.handoff_capture_mask(prev, out), state.qpos,
                state.qvel, pa, out.motion_id)
            steps_out.append((state, out, buf))
        nxt = torch.rand(8, generator=g, device=dev)
    return steps_out, nxt


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["h3d_walk", "g1_getup_k128", "combined"])
def test_graph_replay_matches_eager_step(graph_envs, name):
    """64 steps of step_auto_reset at B 2048, replayed as CUDA graphs
    after the key's warm-up, equal its eager method's bit for bit,
    auto-resets included; the generator's next draw is equal too (the
    replays advanced it as the eager steps did). Every step's outputs
    are compared after the last step: a replay's outputs are the
    caller's and keep their values past the steps after it."""
    from deepmimic_mujoco_tpu_torch.envs.graphs import WARMUP_CALLS
    from deepmimic_mujoco_tpu_torch.utils import tracing

    env = graph_envs[name]
    want, want_next = _graph_rollout(env, eager=True)
    tracing.reset()
    with tracing.collect():
        got, got_next = _graph_rollout(env, eager=False)
    snap = tracing.snapshot()
    tracing.reset()
    assert snap.calls("env.graph_eager") == WARMUP_CALLS
    assert snap.calls("env.graph_replays") == GRAPH_STEPS - WARMUP_CALLS
    assert sum(int(w[1].done.sum()) for w in want) > 0   # resets ran
    for t, (w, g) in enumerate(zip(want, got)):
        wl, gl = _leaves(w), _leaves(g)
        assert len(wl) == len(gl)
        for i, (a, b) in enumerate(zip(wl, gl)):
            assert _same(a, b), (name, t, i)
    assert _same(want_next, got_next)


@pytest.mark.gpu
def test_graph_step_calls_the_solve_once_a_step(graph_envs, monkeypatch):
    """A replayed step calls ``solver.fused_solve_parts`` from Python
    once, one kernel launch, each call with an ``active`` tensor of its
    own (the slot counter and the benchmark's roofline keep it by
    reference and read it later)."""
    env = graph_envs["h3d_walk"]
    seen = []
    entry = solver.fused_solve_parts

    def record(*args, **kw):
        seen.append(args[10])
        return entry(*args, **kw)

    monkeypatch.setattr(solver, "fused_solve_parts", record)
    before = fs.fused_solve.launches
    steps = 8
    _graph_rollout(env, eager=False, steps=steps)
    torch.cuda.synchronize()
    assert len(seen) == fs.fused_solve.launches - before == steps
    assert len({a.data_ptr() for a in seen}) == steps
    assert all(a.dtype == torch.float32 for a in seen)


def test_check_fits_names_the_limit():
    """The error an engine on the card raises when the kernel holds no
    such env names the largest max_contacts that fits: past the register
    plans, the shared memory of one block (runs anywhere)."""
    assert fs.check_fits(34, 16, 28)[:2] == (4, 8)
    assert fs.check_fits(43, 24, 37)[:2] == (4, 16)
    assert not fs.check_fits(43, 25, 37).shared
    for nv, L, k_max in ((43, 37, 384), (34, 28, 480)):
        for K in (26, 29, 64, 128, k_max):
            assert fs.check_fits(nv, K, L).smem_bytes <= fs.SMEM_PER_BLOCK
        with pytest.raises(ValueError,
                           match=f"at most max_contacts={k_max}"):
            fs.check_fits(nv, k_max + 1, L)
        assert fs.max_contacts_on_card(nv, L) == k_max
    with pytest.raises(ValueError, match="no max_contacts fits"):
        fs.check_fits(250, 4, 10)


def test_wrapper_refuses_other_devices():
    args = [torch.empty(a.shape, device="meta") for a in _mk(0, 2, *H3D)]
    with pytest.raises(ValueError, match="unsupported device"):
        fs.fused_solve(*args, K=16, L=28, iterations=5)


def test_parts_wrapper_refuses_other_devices():
    nv, K, L = H3D
    M, _, *vectors = (torch.empty(a.shape, device="meta")
                      for a in _mk(0, 2, nv, K, L))
    parts, ld_idx = _mk_parts(0, 2, nv, K, L)
    parts = [torch.empty(a.shape, device="meta") for a in parts]
    with pytest.raises(ValueError, match="unsupported device"):
        fs.fused_solve_parts(M, *parts, *vectors, K=K, L=L, ld_idx=ld_idx,
                             iterations=5)
    with pytest.raises(ValueError, match="CUDA device only"):
        fs.phase_cycles(*(torch.zeros(a.shape) for a in (M, *parts)),
                        *(torch.zeros(v.shape) for v in vectors), K=K, L=L,
                        ld_idx=ld_idx, iterations=5)


def test_cuda_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        DPEnv(motion="walk", robot="humanoid3d")
    assert resolve_device("cpu") == torch.device("cpu")
