"""The port's spans and counters (``utils/tracing.py``) on the CPU: off
by default, on under a torch profiler (in memory only, on the
profiler's clock) and inside ``collect``, annotated only when asked;
the env step's tree, the solve's slot counter and its bound, the
set-up spans, the PPO phases and the CLI's ``--trace-spans`` rows.
"""
import glob
import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepmimic_mujoco_tpu_torch.envs import DPEnv
from deepmimic_mujoco_tpu_torch.models.physics_model import RK4
from deepmimic_mujoco_tpu_torch.physics import solver
from deepmimic_mujoco_tpu_torch.rl.ppo import PPO, PPOConfig
from deepmimic_mujoco_tpu_torch.utils import tracing

B = 4
# the Euler env step: each span's parent
TREE = {"env.step": None, "env.physics": "env.step",
        "engine.kinematics": "env.physics",
        "engine.collision": "env.physics", "engine.dynamics": "env.physics",
        "engine.constraints": "env.physics",
        "engine.solve": "engine.constraints",
        "engine.integrate": "env.physics", "env.obs": "env.step",
        "env.reward": "env.step", "env.done": "env.step",
        "env.reset": "env.step"}


@pytest.fixture(scope="module")
def built():
    """(env, the set-up spans its build recorded)."""
    tracing.reset()
    env = DPEnv(motion="walk", robot="humanoid3d", device="cpu")
    setup = [s for s in tracing.snapshot().spans
             if s.name.startswith("setup.")]
    tracing.reset()
    return env, setup


def _start(env, seed=0):
    g = torch.Generator().manual_seed(seed)
    states, _ = env.reset(B, generator=g)
    return states, torch.zeros(B, env.action_size), g


def test_off_records_nothing(built):
    env, _ = built
    states, a, g = _start(env)
    tracing.reset()
    assert not tracing.on()
    assert tracing.span("env.step") is tracing.OFF
    with torch.no_grad():
        env.step_auto_reset(states, a, g)
    snap = tracing.snapshot()
    assert snap.spans == [] and snap.counters == {}


def test_profiled_step_records_the_tree_on_the_profilers_clock(built):
    env, _ = built
    states, a, g = _start(env)
    tracing.reset()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as p:
        assert tracing.on()
        env.step_auto_reset(states, a, g)
    assert not tracing.on()
    spans = tracing.snapshot().spans
    by_id = {s.id: s for s in spans}
    assert sorted(s.name for s in spans) == sorted(TREE)
    (top,) = [s for s in spans if s.name == "env.step"]
    assert top.parent is None
    for s in spans:
        parent = by_id.get(s.parent)
        assert (parent.name if parent else None) == TREE[s.name], s.name
        assert s.root == top.id and s.thread == threading.get_ident()
        if parent:
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    events = list(p.profiler.kineto_results.events())
    (col,) = [s for s in spans if s.name == "engine.collision"]
    assert any(e.name().startswith("aten::")
               and col.start_ns <= e.start_ns()
               and e.start_ns() + e.duration_ns() <= col.end_ns
               for e in events)
    # in memory only: nothing of the program's in the profile
    assert not {e.name() for e in events} & set(TREE)
    assert not [e for e in events if e.is_user_annotation()]


def test_collect_annotate_names_the_stages_in_the_profile(built):
    env, _ = built
    states, a, g = _start(env)
    tracing.reset()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as p, \
            tracing.collect(annotate=True):
        env.step_auto_reset(states, a, g)
    names = {e.name() for e in p.profiler.kineto_results.events()}
    assert set(TREE) <= names
    assert {s.name for s in tracing.snapshot().spans} == set(TREE)
    assert not tracing.on()


def test_rk4_repeats_the_engine_stages(built):
    env = DPEnv(motion="walk", robot="humanoid3d", integrator=RK4,
                device="cpu")
    states, a, g = _start(env)
    tracing.reset()
    with torch.no_grad(), tracing.collect():
        env.step_auto_reset(states, a, g)
    names = [s.name for s in tracing.snapshot().spans]
    # four forwards and the pre-step data view's position stage
    assert names.count("engine.solve") == 4
    assert names.count("engine.kinematics") == 5
    assert names.count("engine.integrate") == 5
    assert names.count("env.physics") == 1


def test_slot_counter_is_the_solves_active_argument(built, monkeypatch):
    env, _ = built
    states, a, g = _start(env, seed=3)
    seen = []
    entry = solver.fused_solve_parts

    def recorded(M, *args, **kw):
        seen.append((args[9].clone(), kw["K"], kw["L"]))
        return entry(M, *args, **kw)

    monkeypatch.setattr(solver, "fused_solve_parts", recorded)
    tracing.reset()
    with torch.no_grad(), tracing.collect():
        for _ in range(3):
            states, out = env.step_auto_reset(states, a, g)
    snap = tracing.snapshot()
    assert len(seen) == 3
    assert all(snap.calls(k) == 3 for k in (
        "solve.slots", "solve.active_slots", "solve.limit_rows",
        "solve.active_limit_rows"))
    assert snap.total("solve.slots") == sum(x.shape[0] * K
                                            for x, K, _ in seen)
    assert snap.total("solve.limit_rows") == sum(x.shape[0] * L
                                                 for x, _, L in seen)
    assert snap.total("solve.active_slots") == sum(
        float(x[:, :K].sum()) for x, K, _ in seen)
    assert snap.total("solve.active_limit_rows") == sum(
        float(x[:, 3 * K:].sum()) for x, K, _ in seen)
    assert snap.total("solve.active_slots") > 0


def test_env_build_records_each_setup_span_once(built):
    _, setup = built
    assert sorted(s.name for s in setup) == [
        "setup.mocap", "setup.model", "setup.tables"]
    assert all(s.end_ns >= s.start_ns for s in setup)


def test_ppo_iteration_records_its_phases(built):
    env, _ = built
    cfg = PPOConfig(n_envs=4, horizon=2, epochs=2, minibatch_size=4,
                    target_kl=None, net_arch=(16, 16))
    ppo = PPO(env, cfg)
    tracing.reset()
    ts = ppo.init(0)
    with tracing.collect():
        ppo.train_iter(ts)
    spans = tracing.snapshot().spans
    names = [s.name for s in spans]
    assert names.count("setup.train_state") == 1
    assert names.count("ppo.minibatch") == cfg.epochs * ppo.n_minibatches
    assert names.count("ppo.iter") == 1 and names.count("env.step") == 2
    by_id = {s.id: s for s in spans}
    (it,) = [s for s in spans if s.name == "ppo.iter"]
    for name, parent in (("ppo.rollout", "ppo.iter"), ("ppo.gae", "ppo.iter"),
                         ("ppo.update", "ppo.iter"),
                         ("ppo.policy", "ppo.rollout"),
                         ("env.step", "ppo.rollout"),
                         ("ppo.minibatch", "ppo.update")):
        for s in spans:
            if s.name == name:
                assert by_id[s.parent].name == parent and s.root == it.id
    assert "ppo.host_read" not in names       # no KL guard, no controller
    secs = tracing.seconds_by_name(spans, threading.get_ident())
    assert secs["ppo.iter"] >= secs["ppo.rollout"] + secs["ppo.update"]


def test_counter_keeps_a_bounded_number_of_values(monkeypatch):
    """Past ``PENDING`` values a counter folds what it keeps into a
    running sum; its calls and total are those of every value."""
    monkeypatch.setattr(tracing, "PENDING", 3)
    tracing.reset()
    values = [torch.full((2, 2), float(i)) for i in range(8)]
    with tracing.collect():
        for v in values:
            tracing.count("x", v)
            tracing.count("n", 1)
    calls, folded, pending = tracing.snapshot().counters["x"]
    assert calls == 8 and len(pending) == 2 and folded == 4 * sum(range(6))
    snap = tracing.snapshot()
    assert snap.calls("x") == snap.calls("n") == 8
    assert snap.total("x") == 4 * sum(range(8)) and snap.total("n") == 8
    assert snap.calls("y") == 0 and snap.total("y") == 0.0
    tracing.reset()
    assert tracing.snapshot().counters == {}


def test_collect_records_only_its_own_thread():
    """Another thread's spans and counters stay off while this one
    collects (the CLI's evaluator thread beside its training loop)."""
    def other():
        with tracing.span("other"):
            tracing.count("n", 1)

    tracing.reset()
    with tracing.collect():
        worker = threading.Thread(target=other)
        worker.start()
        worker.join()
        with tracing.span("mine"):
            tracing.count("n", 1)
    snap = tracing.snapshot()
    assert [s.name for s in snap.spans] == ["mine"]
    assert snap.calls("n") == 1


def test_cli_trace_spans_rows(tmp_path):
    from deepmimic_mujoco_tpu_torch.rl.train import main

    main(["smoke", "--env", "deep_mimic_mujoco", "--motion", "walk",
          "--robot", "humanoid3d", "--n-envs", "4", "--horizon", "2",
          "--minibatch", "4", "--epochs", "1", "--total", "16",
          "--eval-every", "1000000", "--trace-spans", "--no-wandb",
          "--no-render", "--device", "cpu", "--out", str(tmp_path)])
    log = glob.glob(str(tmp_path / "*_metrics.jsonl"))[0]
    rows = [json.loads(line) for line in open(log)]
    iters = [r for r in rows if "pg_loss" in r]
    assert len(iters) == 2
    for r in iters:
        assert {"span_s/ppo.rollout", "span_s/ppo.gae",
                "span_s/ppo.update"} <= set(r)
        assert all(v > 0 for k, v in r.items() if k.startswith("span_s/"))
        assert 0 <= r["solve_slot_occupancy_pct"] <= 100
    assert max(r["solve_slot_occupancy_pct"] for r in iters) > 0
    assert not tracing.on()
