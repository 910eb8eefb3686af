"""The train-state checkpoint of a data-parallel run (``rl/checkpoint.py``
with ``parallel/``) on a CPU process group of two gloo ranks.

The JAX package's ``save`` writes a sharded state as its global batch
(``np.asarray`` gathers every shard). The port's does the same: every
rank gathers its env rows, rank 0 writes, and ``restore`` returns the
global state, which ``shard_train_state`` places again. The ranks run in
one launch (a module fixture, ``parallel.dryrun.launch``), whose rank
function lives here: this module imports no JAX.

Held, with humanoid3d walk at the widths of ``test_torch_parallel.py``:
- the state saved right after placement restores, into an unsharded
  template, to the unsharded ``init`` state bit for bit;
- the state saved after one sharded iteration restores to the ranks'
  rows in rank order and rank 0's replicated leaves, bit for bit, and to
  the unsharded iteration's state within ``tests/test_multichip.py``'s
  tolerances;
- one iteration from the restored state, placed again, equals the one
  continued without the round trip, bit for bit;
- the save's collectives: one gather per env-indexed leaf and a barrier.
"""
import os

import pytest
import torch

from deepmimic_mujoco_tpu_torch.envs import DPEnv
from deepmimic_mujoco_tpu_torch.parallel import dryrun, shard_train_state
from deepmimic_mujoco_tpu_torch.rl import checkpoint
from deepmimic_mujoco_tpu_torch.rl import ppo as tppo

WORLD = 2
WALK = dict(n_envs=16, horizon=8, minibatch_size=32, epochs=2,
            net_arch=(32, 16))
TOL_STAT = 1e-4      # tests/test_multichip.py
TOL_PARAM_MC = 5e-4
STATS = ("pg_loss", "v_loss", "entropy", "approx_kl", "clip_frac",
         "mean_reward", "ep_return_sum", "ep_count", "ep_len_sum")


def _ppo():
    env = DPEnv(motion="walk", robot="humanoid3d", iterations=8,
                device="cpu")
    return tppo.PPO(env, tppo.PPOConfig(**WALK))


def _snapshot(ts) -> dict:
    """A copy of every leaf ``save`` writes."""
    c = lambda x: x.detach().clone()
    return {"env_states": {k: c(v) for k, v in
                           ts.env_states._asdict().items()},
            "last_obs": c(ts.last_obs), "ep_return": c(ts.ep_return),
            "ep_length": c(ts.ep_length),
            "params": {k: c(v) for k, v in ts.net.state_dict().items()},
            "mu": [c(x) for x in ts.opt.mu], "nu": [c(x) for x in ts.opt.nu],
            "count": ts.opt.count,
            "gens": {k: g.get_state() for k, g in ts.gens.items()},
            "global_step": ts.global_step, "lr_scale": ts.lr_scale}


def _stats(st) -> dict:
    return {k: float(getattr(st, k)) for k in STATS}


def _rank(mesh, out_dir):
    """Save the sharded state after placement and after one iteration,
    then one more iteration continued and one from the restored state
    placed again."""
    ppo = _ppo()
    ts = shard_train_state(ppo.init(seed=0), mesh)
    checkpoint.save(os.path.join(out_dir, "placed.pt"), ts)
    ts, _ = ppo.train_iter(ts)
    out = {"local": _snapshot(ts)}
    before = dict(mesh.counts)
    path = checkpoint.save(os.path.join(out_dir, "iter1.pt"), ts)
    out["save_counts"] = {k: v - before[k] for k, v in mesh.counts.items()}
    ts, cont = ppo.train_iter(ts)
    out["continued"] = (_stats(cont), _snapshot(ts))
    try:
        back = shard_train_state(checkpoint.restore(path, ppo.init(seed=1)),
                                 mesh)
        back, res = ppo.train_iter(back)
        out["resumed"] = (_stats(res), _snapshot(back))
    except Exception as e:          # held by the test, with its message
        out["resumed"] = repr(e)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("dp_ckpt"))
    ranks = dryrun.launch(_rank, WORLD, args=(out_dir,), device="cpu")
    return out_dir, ranks


def _restored(out_dir, name):
    return _snapshot(checkpoint.restore(os.path.join(out_dir, name),
                                        _ppo().init(seed=1)))


def _assert_equal(want, got, skip=()):
    for k, a in want.items():
        if k in skip:
            continue
        b = got[k]
        if isinstance(a, dict):
            _assert_equal(a, b)
        elif isinstance(a, list):
            assert len(a) == len(b) and all(
                torch.equal(x, y) for x, y in zip(a, b)), k
        elif torch.is_tensor(a):
            assert a.shape == b.shape and torch.equal(a, b), k
        else:
            assert a == b, k


def _scaled(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(a.abs().max()), 1.0))


def test_sharded_save_restores_the_global_init_state(run):
    out_dir, _ = run
    want = _snapshot(_ppo().init(seed=0))
    got = _restored(out_dir, "placed.pt")
    assert got["last_obs"].shape[0] == WALK["n_envs"]
    _assert_equal(want, got)


def test_sharded_save_after_an_iteration_is_the_global_batch(run):
    out_dir, ranks = run
    got = _restored(out_dir, "iter1.pt")
    local = [r["local"] for r in ranks]
    env_keys = ("env_states", "last_obs", "ep_return", "ep_length")
    glued = {"env_states": {k: torch.cat([x["env_states"][k] for x in local])
                            for k in local[0]["env_states"]},
             **{k: torch.cat([x[k] for x in local]) for k in env_keys[1:]}}
    _assert_equal(glued, got)
    _assert_equal(local[0], got, skip=env_keys)
    # and the unsharded run's state after the same iteration
    ppo = _ppo()
    ts, _ = ppo.train_iter(ppo.init(seed=0))
    want = _snapshot(ts)
    for k in ("idx_curr", "episode_length"):
        assert torch.equal(want["env_states"][k], got["env_states"][k]), k
    assert torch.equal(want["ep_length"], got["ep_length"])
    for k in ("qpos", "qvel", "episode_reward"):
        e = _scaled(want["env_states"][k], got["env_states"][k])
        assert e < TOL_PARAM_MC, (k, e)
    for k in ("last_obs", "ep_return"):
        assert _scaled(want[k], got[k]) < TOL_PARAM_MC, k
    for k, a in want["params"].items():
        scale = max(float(a.abs().max()), 1e-3)
        assert float((a - got["params"][k]).abs().max()) / scale \
            < TOL_PARAM_MC, k
    _assert_equal({k: want[k] for k in ("count", "gens", "global_step",
                                        "lr_scale")}, got)


def test_iteration_from_the_restored_state_equals_continuing(run):
    _, ranks = run
    for r in ranks:
        assert not isinstance(r["resumed"], str), r["resumed"]
        (cont, cont_state), (res, res_state) = r["continued"], r["resumed"]
        assert cont == res
        _assert_equal(cont_state, res_state)


def test_sharded_save_gathers_each_env_leaf_once(run):
    _, ranks = run
    n_leaves = len(ranks[0]["local"]["env_states"]) + 3
    for r in ranks:
        counts = r["save_counts"]
        assert counts["all_gather"] == n_leaves
        assert counts["barrier"] == 1
        assert counts["all_reduce"] == counts["broadcast"] == 0
        # each rank sends its rows of every env-indexed leaf once
        local = r["local"]
        rows = [*local["env_states"].values(), local["last_obs"],
                local["ep_return"], local["ep_length"]]
        assert counts["bytes"] == sum(x.numel() * x.element_size()
                                      for x in rows)
