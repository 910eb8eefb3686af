"""``BENCHMARK.json`` and the files it names, found by name.

A traffic mix is ``traffic/<name>.json``, a configuration the ``file``
its entry names, a driver ``drivers/<name>.py`` (named by the traffic
file), a fault ``faults/<name>.py`` (named by a driver's ``FAULTS``), a
per-layer metric's reader ``metrics/<metric>.py`` and a cell's limits
``reference/limits/<cell>.json``."""
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(ROOT, c["file"]))
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def limits(cell: str) -> dict:
    path = os.path.join(BENCH_DIR, "reference", "limits", f"{cell}.json")
    return load_json(path)["limits"] if os.path.exists(path) else {}


def module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, loaded by path
    (metric names hold dots)."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str, reported) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def end_to_end(bench: dict, cell: str) -> list:
    return [m for m in bench["end_to_end"] if _applies(m, cell, None)]


def per_layer(bench: dict, cell: str) -> list:
    reported = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"] if _applies(m, cell, reported)]
