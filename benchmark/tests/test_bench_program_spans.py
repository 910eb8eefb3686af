"""The readers of the program's own spans and counters
(``metrics/env_step_host_ms.*``, ``ppo_minibatch_host_ms.train``,
``solve_slot_occupancy_pct.*``): a traced CPU run of each cell at the
tests' sizes prints each of them, with their context in the info
line."""
import json

import pytest

from bmk import run as bmk_run
from bmk import spec
from conftest import TINY

BENCH_JSON = spec.benchmark()
CELLS = [w["name"] for w in BENCH_JSON["workloads"]]
SEED = 3_000_000_321
PROGRAM = ("env_step_host_ms.", "ppo_minibatch_host_ms.",
           "solve_slot_occupancy_pct.")


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_programs_spans(cell, capsys):
    from deepmimic_mujoco_tpu_torch.utils import tracing

    want = {m["name"] for m in spec.per_layer(BENCH_JSON, cell)
            if m["name"].startswith(PROGRAM)}
    assert want
    tracing.reset()
    out = bmk_run.main(["--workload", cell, "--seed", str(SEED),
                        "--seconds", "0.5", "--trace", "1"],
                       device="cpu", sizes=TINY)
    printed = capsys.readouterr().out.strip().splitlines()
    info = json.loads(printed[-2][len("info "):])
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert want <= set(got)
    for name in want:
        if name.startswith("solve_slot_occupancy_pct."):
            assert 0.0 <= got[name] <= 100.0
        else:
            assert got[name] > 0
    slots = info["solve_slots"]
    assert slots["calls"] == slots["recorded_calls"] > 0
    assert 0.0 <= slots["limit_rows_active_pct"] <= 100.0
    steps = TINY["trace_steps"] if "rollout" in cell else TINY["horizon"]
    assert slots["calls"] == steps
    assert {"env.step", "env.physics", "engine.solve",
            "env.reset"} <= set(info["env_step_self_ms"])
    assert {"setup.model", "setup.tables", "setup.mocap"} <= set(
        info["setup_spans_s"])
    assert 0 < info["setup_unspanned_s"] < info["setup_s"]
    if "ppo" in cell:
        ppo = info["ppo_spans"]
        assert ppo["minibatch_steps"] > 0
        assert {"ppo.iter", "ppo.rollout", "ppo.policy", "ppo.handoff",
                "ppo.gae", "ppo.update",
                "ppo.minibatch"} <= set(ppo["seconds"])
    assert not tracing.on()
