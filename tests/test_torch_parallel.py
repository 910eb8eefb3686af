"""Data-parallel PPO of the port (``parallel/``) on CPU process groups.

Ranks are spawned processes joined over gloo through a ``file://`` store
(``parallel.dryrun.launch``); each world's jobs run in one launch (a
module fixture), and the tests read their results. The rank functions
live here, so a rank imports this module: it imports no JAX at the top
(the JAX references are computed in the parent, inside the fixtures).

Held:
- (a) placement: ``shard_train_state`` slices every env-indexed leaf of
  rank 0's state and replicates the rest, identical on every rank;
- (b) the port sharded over 2 and 4 ranks against the JAX package's
  ``_train_iter`` (itself sharded by its own ``shard_train_state`` on a
  virtual CPU mesh) with the table env and forced draws of
  ``test_torch_ppo.py``: losses 1e-5 relative, params 1e-5 scaled, the
  first minibatch's gradients (averaged over the ranks) 1e-4 scaled;
- (c) humanoid3d walk, world 1 (unsharded) against worlds 2 and 4, as
  ``tests/test_multichip.py:40-81`` holds the JAX package: stats 1e-4
  relative (absolute below 1), params 5e-4 scaled, and the params
  bitwise equal on every rank;
- (d) the combined env with the handoff buffer armed: every rank's ring
  buffer bitwise equal, and equal to the unsharded one (rows, head and
  count exact; states 5e-4 scaled);
- (e) every shard-aware draw is the slice of the unsharded draw;
- (f) the guards raise, and nothing moves to the CPU instead;
- (g) the dry run prints its OK line.
"""
from typing import NamedTuple

import numpy as np
import pytest
import torch

from deepmimic_mujoco_tpu_torch.envs import (
    DPCombinedEnv, DPCombinedEnvConfig, DPEnv,
)
from deepmimic_mujoco_tpu_torch.parallel import (
    data_sharding, make_mesh, replicated, shard_train_state,
)
from deepmimic_mujoco_tpu_torch.parallel import dryrun, mesh as mesh_lib
from deepmimic_mujoco_tpu_torch.rl import ppo as tppo

TOL_LOSS = 1e-5      # tests/test_torch_ppo.py
TOL_PARAM = 1e-5
TOL_GRAD = 1e-4
TOL_STAT = 1e-4      # tests/test_multichip.py
TOL_PARAM_MC = 5e-4
STATS = ("pg_loss", "v_loss", "entropy", "approx_kl", "clip_frac",
         "v_loss_max", "mean_reward", "ep_return_sum", "ep_count",
         "ep_len_sum", "log_std_mean", "contact_overflow_max")
# (c): tests/test_multichip.py:54-56
WALK = dict(n_envs=16, horizon=8, minibatch_size=32, epochs=2,
            net_arch=(32, 16))
# (d): enough handoffs in two iterations to wrap a 4-row ring buffer
COMBINED_ENV = dict(HANDOFF_RSI_FRAC=1.0, HANDOFF_BUFFER_FRAC=0.5,
                    RSI_RANDOM_PA=True)
COMBINED = dict(n_envs=16, horizon=16, minibatch_size=32, epochs=2,
                net_arch=(32, 16), handoff_buffer_cap=4)


def _make_env(kind):
    if kind == "combined":
        return DPCombinedEnv(cfg=DPCombinedEnvConfig(**COMBINED_ENV),
                             device="cpu")
    return DPEnv(motion="walk", robot="humanoid3d", iterations=8,
                 device="cpu")


def _stats(st) -> dict:
    return {k: float(getattr(st, k)) for k in STATS}


def _flat(net) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in net.parameters()])


def _iterations(kind, kw, n_iters, mesh=None):
    """``n_iters`` PPO iterations from ``init(seed=0)``, sharded over
    ``mesh`` when given: per-iteration stats, final params, handoff
    buffer and the collectives' counts."""
    env = _make_env(kind)
    ppo = tppo.PPO(env, tppo.PPOConfig(**kw))
    ts = ppo.init(seed=0)
    if mesh is not None:
        ts = shard_train_state(ts, mesh)
        before = dict(mesh.counts)
    stats = []
    for _ in range(n_iters):
        ts, st = ppo.train_iter(ts)
        stats.append(_stats(st))
    out = {"stats": stats, "params": {k: v.clone() for k, v in
                                      ts.net.state_dict().items()},
           "buf": ts.handoff_buf, "local": ts.last_obs.shape[0]}
    if mesh is not None:
        # the collectives of the iterations alone
        out["counts"] = {k: v - before[k] for k, v in mesh.counts.items()}
        rep = replicated(mesh)
        out["same"] = {
            "params": rep.check(_flat(ts.net)),
            "adam": all(rep.check(x) for x in (*ts.opt.mu, *ts.opt.nu)),
            "gens": all(rep.check(g.get_state())
                        for g in ts.gens.values()),
            "buf": ts.handoff_buf is None or all(
                rep.check(x) for x in ts.handoff_buf)}
    return out


# ---- the table env of tests/test_torch_ppo.py, shard-aware ---------------
class TOut(NamedTuple):
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    vel_match: torch.Tensor
    contact_overflow: torch.Tensor


class ShardedScripted:
    """The table env of ``tests/test_torch_ppo.py`` (state: the time
    index): each step returns row ``t`` of the tables whatever the
    actions, sliced to the rank's envs."""
    device = torch.device("cpu")

    def __init__(self, obs_t, rew, done, vm):
        self.obs_t, self.rew = torch.tensor(obs_t), torch.tensor(rew)
        self.done, self.vm = torch.tensor(done), torch.tensor(vm)
        self.obs_size = obs_t.shape[-1]
        self.action_size = 3

    def reset(self, n_envs, generator=None):
        return 0, self.obs_t[0]

    def step_auto_reset(self, t, action, generator=None, shard=None):
        cut = (lambda x: x) if shard is None else shard.shard
        n = action.shape[0]
        return t + 1, TOut(cut(self.obs_t[t + 1]), cut(self.rew[t]),
                           cut(self.done[t]), cut(self.vm[t]),
                           torch.zeros(n, dtype=torch.int64))


class Forced(tppo.PPO):
    """The port's trainer fed the JAX package's (global) draws; it keeps
    the first minibatch step's gradients as the clip receives them
    (averaged over the ranks, when sharded)."""

    def __init__(self, env, cfg, noises, perms):
        super().__init__(env, cfg)
        self.noises, self.perms = list(noises), list(perms)
        self.first_grads = None

    def _clip_grads(self, params):
        if self.first_grads is None:
            self.first_grads = [p.grad.clone() for p in params]
        super()._clip_grads(params)

    def draw_noise(self, ts, mean):
        return torch.tensor(self.noises.pop(0))

    def draw_perm(self, ts, n):
        return torch.tensor(self.perms.pop(0), dtype=torch.int64)


def _scripted(kw, tables, noises, perms, init, n_iters, mesh=None):
    """The port's iterations of the table env with the JAX draws: per
    iteration (stats, params), and the first minibatch's gradients."""
    tp = Forced(ShardedScripted(*tables), tppo.PPOConfig(**kw), noises,
                perms)
    ts = tp.init(seed=0)
    ts.net.load_state_dict(init)
    if mesh is not None:
        ts = shard_train_state(ts, mesh)
    out = []
    for _ in range(n_iters):
        ts, st = tp.train_iter(ts)
        out.append((_stats(st) | {"lr_scale": st.lr_scale,
                                  "global_step": ts.global_step},
                    {k: v.clone() for k, v in ts.net.state_dict().items()}))
    names = [k for k, _ in ts.net.named_parameters()]
    return out, dict(zip(names, tp.first_grads))


def _placement(mesh):
    """Rank r builds its state from seed r; after the placement every
    rank holds rank 0's (seed 0), sliced or whole."""
    ppo = tppo.PPO(_make_env("walk"), tppo.PPOConfig(**WALK))
    ts = shard_train_state(ppo.init(seed=mesh.rank), mesh)
    rep = replicated(mesh)
    return {"env_states": ts.env_states, "last_obs": ts.last_obs,
            "ep_return": ts.ep_return, "ep_length": ts.ep_length,
            "params": ts.net.state_dict(), "mu": ts.opt.mu,
            "gens": {k: g.get_state() for k, g in ts.gens.items()},
            "mesh": (ts.mesh.world, ts.mesh.rank, str(ts.mesh.device),
                     ts.mesh.backend, ts.mesh.axis),
            "same": rep.check(_flat(ts.net))
            and all(rep.check(g.get_state()) for g in ts.gens.values())}


def _world_jobs(mesh, jobs):
    """Each (name, function, args) of ``jobs`` on this rank's mesh;
    {name: result}."""
    return {name: fn(*args, mesh=mesh) for name, fn, args in jobs}


# ---- the JAX references (parent only) -------------------------------------
def _jax_scripted(case, world):
    """The JAX package's two iterations of ``test_torch_ppo``'s table env
    for ``case``, sharded over a ``world``-device virtual CPU mesh: the
    config, the tables, its draws, its initial params, per iteration its
    stats and params, and its first minibatch's raw gradients (port
    state dicts)."""
    import jax
    import jax.numpy as jnp
    import optax
    import test_torch_ppo as tp_ref
    from deepmimic_mujoco_tpu.parallel import make_mesh as jmake_mesh
    from deepmimic_mujoco_tpu.parallel import (
        shard_train_state as jshard_train_state,
    )
    from deepmimic_mujoco_tpu.rl.ppo import PPO as JPPO
    from deepmimic_mujoco_tpu.rl.ppo import PPOConfig as JConfig

    from deepmimic_mujoco_tpu_torch.rl.convert import params_from_flax

    N, H, B = tp_ref.N, tp_ref.H, tp_ref.B
    kw = dict(n_envs=N, horizon=H, minibatch_size=8, epochs=2, lr=1e-2,
              net_arch=tp_ref.ARCH, total_timesteps=tp_ref.ITERS * B,
              init_log_std=-0.5)
    kw.update(tp_ref.CASES[case])
    jppo = JPPO(tp_ref.JScripted(), JConfig(**kw))
    jppo.tx = optax.chain(tp_ref._capture_first_grads(), jppo.tx)
    jts = jppo.init(seed=3)
    jts = jts._replace(
        env_states=(jnp.arange(N, dtype=jnp.int32),
                    jnp.zeros(N, jnp.int32)),
        last_obs=jnp.asarray(tp_ref.OBS_T[0]))
    key, noises, perms = jts.key, [], []
    for _ in range(tp_ref.ITERS):
        for _ in range(H):
            key, akey = jax.random.split(key)
            noises.append(np.asarray(jax.random.normal(akey, (N, 3))))
        for _ in range(kw["epochs"]):
            key, pkey = jax.random.split(key)
            perms.append(np.asarray(jax.random.permutation(pkey, B)))
    as_port = lambda p: params_from_flax(jax.tree.map(np.asarray, p),
                                         tp_ref.ARCH)
    init = as_port(jts.params)
    mesh = jmake_mesh(world)
    ref = []
    with mesh:
        jts = jshard_train_state(jts, mesh)
        assert len(jts.last_obs.sharding.device_set) == world
        for _ in range(tp_ref.ITERS):
            jts, js = jppo._train_iter(jts)
            ref.append(({k: float(getattr(js, k)) for k in STATS
                         if k != "contact_overflow_max"}
                        | {"lr_scale": float(js.lr_scale),
                           "global_step": int(jts.global_step)},
                        as_port(jts.params)))
    tables = (tp_ref.OBS_T, tp_ref.REW, tp_ref.DONE, tp_ref.VM)
    grads = as_port(jts.opt_state[0][1])
    return kw, tables, noises, perms, init, (ref, grads)


def _run_world(world):
    refs = {case: _jax_scripted(case, world) for case in SCRIPTED_CASES}
    jobs = [(f"scripted_{c}", _scripted, (kw, tables, noises, perms, init,
                                          len(ref[0])))
            for c, (kw, tables, noises, perms, init, ref) in refs.items()]
    jobs.append(("walk", _iterations, ("walk", WALK, 1)))
    if world == 2:
        jobs.append(("placement", _placement, ()))
        jobs.append(("combined", _iterations, ("combined", COMBINED, 2)))
    ranks = dryrun.launch(_world_jobs, world, args=(jobs,), device="cpu")
    return refs, ranks


SCRIPTED_CASES = ("base", "kl_guard", "adaptive_lr", "lr_decay", "clip_vf",
                  "shaping")


@pytest.fixture(scope="module")
def world2():
    return _run_world(2)


@pytest.fixture(scope="module")
def world4():
    return _run_world(4)


@pytest.fixture(scope="module")
def unsharded():
    return {"walk": _iterations("walk", WALK, 1),
            "combined": _iterations("combined", COMBINED, 2)}


def _worlds(request, world):
    return request.getfixturevalue(f"world{world}")


def _scaled(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(a.abs().max()), 1.0))


def _rel(a, b):
    return abs(a - b) / max(abs(a), 1e-8)


# ---- (a) ------------------------------------------------------------------
def test_placement_slices_env_leaves_and_replicates_the_rest(world2):
    _, ranks = world2
    ppo = tppo.PPO(_make_env("walk"), tppo.PPOConfig(**WALK))
    ref = ppo.init(seed=0)
    n = WALK["n_envs"] // 2
    for r, res in enumerate(ranks):
        got = res["placement"]
        assert got["mesh"] == (2, r, "cpu", "gloo", "data")
        assert got["same"]
        sl = slice(r * n, (r + 1) * n)
        for name, a, b in zip(ref.env_states._fields, ref.env_states,
                              got["env_states"]):
            assert b.shape[0] == n and torch.equal(a[sl], b), name
        for k in ("last_obs", "ep_return", "ep_length"):
            assert torch.equal(getattr(ref, k)[sl], got[k]), k
        for k, v in ref.net.state_dict().items():
            assert torch.equal(v, got["params"][k]), k
        assert all(torch.equal(a, b) for a, b in zip(ref.opt.mu, got["mu"]))
        for k, g in ref.gens.items():
            assert torch.equal(g.get_state(), got["gens"][k]), k


# ---- (b) ------------------------------------------------------------------
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", SCRIPTED_CASES)
def test_sharded_port_matches_jax(request, world, case):
    refs, ranks = _worlds(request, world)
    ref, ref_grads = refs[case][-1]
    for res in ranks:
        got, grads = res[f"scripted_{case}"]
        # the first step's gradients, averaged over the ranks
        gerr = max(_scaled(ref_grads[k], grads[k]) for k in ref_grads)
        assert gerr < TOL_GRAD, gerr
        assert len(got) == len(ref)
        for it, ((js, jp), (ts, tp)) in enumerate(zip(ref, got)):
            bad = {k: _rel(v, ts[k]) for k, v in js.items()
                   if not _rel(v, ts[k]) < TOL_LOSS}
            assert not bad, (it, bad)
            perr = max(_scaled(jp[k], tp[k]) for k in jp)
            assert perr < TOL_PARAM, (it, perr)
    # every rank ends with the same params, bit for bit
    last = [res[f"scripted_{case}"][0][-1][1] for res in ranks]
    assert all(torch.equal(last[0][k], p[k]) for p in last[1:] for k in p)


# ---- (c) ------------------------------------------------------------------
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_walk_matches_unsharded(request, unsharded, world):
    """tests/test_multichip.py:40-81 for the port: one iteration of 16
    humanoid3d walk envs, unsharded and sharded over ``world`` ranks."""
    _, ranks = _worlds(request, world)
    want = unsharded["walk"]
    for res in ranks:
        got = res["walk"]
        assert got["local"] == WALK["n_envs"] // world
        assert all(got["same"].values()), got["same"]
        for k, a in want["stats"][0].items():
            b = got["stats"][0][k]
            assert abs(a - b) <= TOL_STAT * max(1.0, abs(a)), (k, a, b)
        for k, a in want["params"].items():
            b = got["params"][k]
            scale = max(float(a.abs().max()), 1e-3)
            assert float((a - b).abs().max()) / scale < TOL_PARAM_MC, k
    # the collectives of one iteration: the stats (2), one gradient
    # all_reduce per minibatch step and one loss all_reduce per epoch;
    # one gather of the trajectory
    n_mb = WALK["n_envs"] * WALK["horizon"] // WALK["minibatch_size"]
    counts = ranks[0]["walk"]["counts"]
    assert counts["all_reduce"] == 2 + WALK["epochs"] * (n_mb + 1)
    assert counts["all_gather"] == 1


# ---- (d) ------------------------------------------------------------------
def test_sharded_combined_handoff_buffer_matches_unsharded(world2,
                                                           unsharded):
    _, ranks = world2
    want = unsharded["combined"]
    buf = want["buf"]
    assert int(buf.count) == COMBINED["handoff_buffer_cap"]
    for res in ranks:
        got = res["combined"]
        assert all(got["same"].values()), got["same"]
        gbuf = got["buf"]
        for k in ("pa", "motion", "head", "count"):
            assert torch.equal(getattr(buf, k), getattr(gbuf, k)), k
        assert _scaled(buf.qpos, gbuf.qpos) < TOL_PARAM_MC
        assert _scaled(buf.qvel, gbuf.qvel) < TOL_PARAM_MC
        for sw, sg in zip(want["stats"], got["stats"]):
            for k in ("ep_count", "contact_overflow_max"):
                assert sw[k] == sg[k], k
            for k in ("pg_loss", "v_loss", "mean_reward"):
                assert abs(sw[k] - sg[k]) <= TOL_STAT * max(1.0, abs(sw[k]))
    # the rollout gathers the handoff rows once a step, the trajectory once
    assert ranks[0]["combined"]["counts"]["all_gather"] == \
        2 * (COMBINED["horizon"] + 1)


# ---- (e) ------------------------------------------------------------------
def _fake_sharding(world, rank):
    """The data sharding of rank ``rank`` of ``world``: slicing needs no
    group."""
    return data_sharding(mesh_lib.Mesh(world=world, rank=rank,
                                       device=torch.device("cpu"),
                                       backend="gloo"))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_draws_are_slices_of_the_global_draws(world):
    n = 8
    k = n // world
    walk = DPEnv(motion="walk", robot="humanoid3d", device="cpu")
    comb = _make_env("combined")
    buf = comb.make_handoff_buffer(4)
    buf = buf._replace(count=torch.tensor(3))
    ppo = tppo.PPO(walk, tppo.PPOConfig(n_envs=n, horizon=2,
                                        minibatch_size=8))
    ts = ppo.init(seed=0)
    mean = torch.zeros(n, walk.action_size)

    def draws(shard):
        g = lambda: torch.Generator().manual_seed(5)
        m = k if shard is not None else n
        ts.gens["act"] = g()
        ts.mesh = None if shard is None else shard.mesh
        noise = ppo.draw_noise(ts, mean[:m])
        return {"noise": noise if shard is None else shard.shard(noise),
                "frames": walk.reset(m, g(), shard=shard)[0].idx_curr,
                "reset": comb._reset_state(m, g(), buf, shard=shard),
                "forced": comb._reset_state(m, draws=forced, shard=shard,
                                            handoff_buf=buf)}

    forced = comb.draw_reset(n, torch.Generator().manual_seed(6), buf)
    full = draws(None)
    for r in range(world):
        got = draws(_fake_sharding(world, r))
        sl = slice(r * k, (r + 1) * k)
        assert torch.equal(full["noise"][sl], got["noise"])
        assert torch.equal(full["frames"][sl], got["frames"])
        for key in ("reset", "forced"):
            for name, a, b in zip(full[key]._fields, full[key], got[key]):
                assert torch.equal(a[sl], b), (key, name)


# ---- (f) ------------------------------------------------------------------
def test_guards_raise(tmp_path, monkeypatch):
    ppo = tppo.PPO(_make_env("walk"), tppo.PPOConfig(
        n_envs=8, horizon=2, minibatch_size=9))
    ts = ppo.init(seed=0)
    with pytest.raises(ValueError, match="split over 3"):
        shard_train_state(ts, mesh_lib.Mesh(
            world=3, rank=0, device=torch.device("cpu"), backend="gloo"))
    ts.mesh = mesh_lib.Mesh(world=2, rank=0, device=torch.device("cpu"),
                            backend="gloo")
    with pytest.raises(ValueError, match="minibatch_size 9"):
        ppo.train_iter(ts)
    assert ts.global_step == 0
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh()
    # a CUDA request without a card, and NCCL on CPU tensors
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.init_group(0, 1, f"file://{tmp_path}/s", device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(ValueError, match="use gloo"):
        dryrun.launch(dryrun._dryrun_rank, 2, device="cpu", backend="nccl")
    assert not torch.distributed.is_initialized()
    # one card: NCCL refuses two ranks on it; gloo only when asked for
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="NCCL refuses"):
        mesh_lib.pick_backend("cuda", 2)
    assert mesh_lib.pick_backend("cuda", 2, "gloo") == "gloo"
    assert mesh_lib.pick_backend("cuda", 1) == "nccl"
    assert mesh_lib.rank_device("cuda", 1) == torch.device("cuda", 0)


def test_world1_in_process_equals_unsharded(tmp_path, unsharded):
    """World 1 over gloo in this process: every collective runs, and the
    iteration equals the unsharded one bit for bit."""
    m = mesh_lib.init_group(0, 1, f"file://{tmp_path}/store", device="cpu")
    try:
        got = _iterations("walk", WALK, 1, mesh=m)
    finally:
        torch.distributed.destroy_process_group()
    assert got["stats"] == unsharded["walk"]["stats"]
    for k, v in unsharded["walk"]["params"].items():
        assert torch.equal(v, got["params"][k]), k
    assert got["counts"]["bytes"] > 0


# ---- (g) ------------------------------------------------------------------
def test_dryrun_multichip_cpu(capfd):
    reward = dryrun.dryrun_multichip(4, device="cpu")
    out = capfd.readouterr().out
    assert f"dryrun_multichip(4) OK: mean_reward={reward:.4f}" in out
    assert np.isfinite(reward)
