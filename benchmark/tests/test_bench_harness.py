"""The harness on the CPU: names, files, units, the result line, the
frozen counts, the imports, and a run with the timed path broken."""
import json
import os
import re
import subprocess
import sys

import pytest

from bmk import run as bmk_run
from bmk import spec
from conftest import BENCH, TINY

BANNED = ("jax", "jaxlib", "flax", "deepmimic_mujoco_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH_JSON = spec.benchmark()
CELLS = [w["name"] for w in BENCH_JSON["workloads"]]
SEED = 3_000_000_123


def _driver(cell):
    """The driver module of ``cell``, named by its traffic file."""
    tr = spec.traffic(spec.workload(BENCH_JSON, cell)["traffic"])
    return spec.module("drivers", tr["driver"])


def test_every_name_is_found():
    b = BENCH_JSON
    for c in b["configs"]:
        cfg = spec.config(b, c["name"])
        assert cfg["source"] == c["source"]
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
    for w in b["workloads"]:
        faults = getattr(_driver(w["name"]), "FAULTS", ())
        assert faults, w["name"]
        for f in faults:
            assert callable(spec.module("faults", f).plant), f
        assert spec.limits(w["name"]), w["name"]
        spec.config(b, w["config"])
    for m in b["per_layer"]:
        assert callable(spec.module("metrics", m["name"]).read)


def test_names_and_units():
    b = BENCH_JSON
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        names.append(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    layers = {m["layer"] for m in b["per_layer"]}
    assert all("\n" not in x and len(x) <= 200 for x in layers)


def test_suffixed_metrics_sit_with_their_end_to_end_metric():
    b = BENCH_JSON
    moves = {".rollout": "rollout_env_steps_per_s",
             ".train": "train_memory_peak_gb"}
    for m in b["per_layer"]:
        sfx = m["name"][m["name"].rindex("."):]
        assert m["moves"] == moves[sfx]
        for cell in m["workloads"]:
            reported = {e["name"] for e in spec.end_to_end(b, cell)}
            assert m["moves"] in reported and "setup_s" in reported
    for cell in CELLS:
        assert spec.per_layer(b, cell)
        assert len(spec.end_to_end(b, cell)) >= 2


def _run(cell, trace, capsys, fault=None):
    out = bmk_run.main(["--workload", cell, "--seed", str(SEED),
                        "--seconds", "0.5", "--trace", str(trace)],
                       device="cpu", sizes=TINY, fault=fault)
    printed = capsys.readouterr()
    return out, printed


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cpu_run_prints_a_result_line(cell, trace, capsys):
    out, printed = _run(cell, trace, capsys)
    last = json.loads(printed.out.strip().splitlines()[-1])
    assert set(last) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert list(last)[-1] == "compared"
    assert last["attempted"] > 0
    if spec.workload(BENCH_JSON, cell)["chips"] > 1:
        # over gloo ranks the check follows rank 0's share of each
        # minibatch: a sound run meets the cell's limits
        assert last["correct"] is True, last["compared"]
    if trace:
        allowed = {m["name"] for m in spec.per_layer(BENCH_JSON, cell)}
        # the CPU profile holds no device kernels: only spans are read
        assert set(last["metrics"]) <= allowed
        host = {m["name"] for m in spec.per_layer(BENCH_JSON, cell)
                if m["source"] == "host_clock"}
        assert host <= set(last["metrics"])
    else:
        want = {m["name"] for m in spec.end_to_end(BENCH_JSON, cell)}
        assert set(last["metrics"]) == want
        # the CPU holds no card memory: a memory peak reads 0 here
        assert all(v["value"] > 0 for v in last["metrics"].values()
                   if v["unit"] != "GB")
    tail = printed.err.strip().splitlines()[-len(last["compared"]):]
    assert all(line.startswith("compared ") for line in tail)
    assert not {m.split(".")[0] for m in sys.modules} & set(BANNED)


def test_frozen_solve_count_is_bound_ms():
    from counts import solve
    from deepmimic_mujoco_tpu_torch.ops.fused_solve import bound_ms

    for nv, K, L in ((34, 16, 28), (43, 24, 37), (43, 128, 37)):
        for B in (1, 2048):
            ms, _ = bound_ms(B, nv, K, L, 50, entry="parts")
            ours = solve.bound_s(solve.all_slots_ops(B, nv, K, L, 50),
                                 solve.call_bytes(B, nv, K, L)) * 1e3
            assert ours == pytest.approx(ms, rel=1e-12)


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path[:0] = [%r]\n"
            "from reference import check, policy, ppo, solve\n"
            "from reference.envs import DPEnv, DPCombinedEnv\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'deepmimic_mujoco_tpu', "
            "'deepmimic_mujoco_tpu_torch'})\n"
            "print(bad)") % BENCH
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd="/")
    assert out.stdout.strip() == "[]"
    for root, _, files in os.walk(os.path.join(BENCH, "reference")):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                assert not re.search(r"^\s*(from|import) (deepmimic|jax)",
                                     src, re.M), f


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in getattr(_driver(c), "FAULTS", ())])
def test_a_broken_timed_path_is_not_correct(cell, fault, capsys):
    out, _ = _run(cell, 0, capsys, fault)
    assert out["correct"] is False
    failed = [k for k, v in out["compared"].items()
              if v["value"] > v["limit"]]
    assert failed, out["compared"]
