"""A cell whose driver no existing file names comes in as new files and
entries in ``BENCHMARK.json`` alone: on a copy of the benchmark, a new
driver with its ``FAULTS``, a new fault, a traffic file and a limits
file, and the harness's name, result-line and broken-path tests collect
and pass on the copy, with no copied file changed but ``BENCHMARK.json``."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH

ROOT = os.path.dirname(BENCH)
CELL = "humanoid3d.rollout_walk_scaled"
DRIVER = '''"""A walk rollout through a driver of its own, with a fault of its
own: ``drivers/rollout.py``'s run."""
from bmk import spec

FAULTS = ("scaled_action",)


def run(ctx):
    return spec.module("drivers", "rollout").run(ctx)
'''
FAULT = '''"""The env step takes the sampled action scaled by 1.01."""


def plant(patch):
    from deepmimic_mujoco_tpu_torch.envs import dp_env

    patch(dp_env.DPEnv, "step_auto_reset",
          lambda f: lambda self, st, a, *g, **k: f(self, st, a * 1.01, *g,
                                                   **k))
'''


def _digests(top):
    out = {}
    for root, dirs, files in os.walk(top):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(root, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, top)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _write(path, text):
    with open(path, "w") as fh:
        fh.write(text)


def test_a_cell_with_a_new_driver_comes_in_as_files(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    before = _digests(tmp_path)

    _write(bench / "drivers" / "rollout_scaled.py", DRIVER)
    _write(bench / "faults" / "scaled_action.py", FAULT)
    with open(bench / "traffic" / "rollout_walk.json") as fh:
        traffic = json.load(fh)
    _write(bench / "traffic" / "rollout_walk_scaled.json",
           json.dumps(dict(traffic, driver="rollout_scaled")))
    shutil.copy(bench / "reference" / "limits"
                / "humanoid3d.rollout_walk.json",
                bench / "reference" / "limits" / f"{CELL}.json")
    with open(tmp_path / "BENCHMARK.json") as fh:
        b = json.load(fh)
    b["workloads"].append(dict(
        name=CELL, config="humanoid3d", traffic="rollout_walk_scaled",
        chips=1, why="the walk rollout through a driver of its own"))
    for m in b["end_to_end"] + b["per_layer"]:
        if "humanoid3d.rollout_walk" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    _write(tmp_path / "BENCHMARK.json", json.dumps(b, indent=1))

    # the port from this checkout; the reference reads the assets beside it
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONDONTWRITEBYTECODE="1",
               DM_TPU_ASSET_ROOT=os.path.join(ROOT, "deepmimic_mujoco_tpu",
                                              "assets"))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         str(bench / "tests" / "test_bench_harness.py"), "-k",
         f"every_name or names_and_units or suffixed or {CELL}"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    # three name checks, two result lines (trace 0 and 1), one broken path
    assert "6 passed" in out.stdout, out.stdout[-2000:]

    after = _digests(tmp_path)
    changed = sorted(k for k in before if after.get(k) != before[k])
    assert changed == ["BENCHMARK.json"], changed
