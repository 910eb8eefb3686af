"""One run of one cell: set-up, the measured window, the check, the
result line."""
import dataclasses
import json
import os
import sys
import time

from bmk import card, faults, spec

BANNED = ("jax", "jaxlib", "flax", "deepmimic_mujoco_tpu")


@dataclasses.dataclass
class Run:
    """What a driver and a metric reader see of a run."""
    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float                       # process start (host clock)
    sizes: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)
    info: dict = dataclasses.field(default_factory=dict)
    profile: object = None          # trace.Profile of a traced run
    hp: dict = None                 # the PPO hyperparameters run
    obs_act: tuple = None           # (observation, action) widths
    caps: object = None             # what the check compares

    def size(self, key: str):
        """A traffic size, or the tests' smaller one."""
        return self.sizes.get(key, self.traffic[key])

    def span(self, name: str, seconds: float):
        self.spans.setdefault(name, []).append(seconds)

    def check_model(self, engine):
        """The built engine has the configuration file's sizes (contact
        slots: the traffic's, else the file's)."""
        m, c = engine.m, self.config
        got = dict(nq=m.nq, nv=m.nv, nbody=m.nbody, nu=m.nu,
                   limit_rows=len(engine.limit_table[0]),
                   solver_iterations=engine.iterations, timestep=engine.dt,
                   max_contacts=engine.max_contacts)
        want = dict(c, max_contacts=self.traffic.get("max_contacts",
                                                     c["max_contacts"]))
        for k, v in got.items():
            if want[k] != v:
                raise SystemExit(f"{k} {v} built, the cell says {want[k]}")
        self.info["sizes"] = got


def cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's nvcc build is ``build/torch_kernels`` in the checkout)."""
    base = os.path.join(spec.ROOT, "build", "bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(base, "kernels")


def banned_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def percentile(xs, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation."""
    xs = sorted(xs)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def main(argv=None, device: str = "cuda", sizes=None, t0=None, fault=None):
    """Run a cell once and print its result. ``device="cpu"``, ``sizes``
    and ``fault`` (one of ``bmk.faults``) are for the tests: a real run
    needs the card and plants nothing."""
    import argparse

    t0 = time.time() if t0 is None else t0
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs()
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    card.require(cell["chips"], device)
    traffic = spec.traffic(cell["traffic"])
    run = Run(name=cell["name"], cell=cell,
              config=spec.config(bench, cell["config"]), traffic=traffic,
              seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              device=device, t0=t0, sizes=dict(sizes or {}))
    driver = spec.module("drivers", traffic["driver"])
    if fault:
        run.info["fault"] = fault
    with faults.fault(fault):
        out = driver.run(run)
    found = banned_modules()
    if found:
        print("modules of JAX or the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        raise SystemExit(4)
    if args.trace:
        metrics = {}
        for m in spec.per_layer(bench, run.name):
            value = spec.module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]],
                               "unit": m["unit"]}
                   for m in spec.end_to_end(bench, run.name)}
    limits = spec.limits(run.name)
    compared = out["compared"]
    correct = bool(compared) and all(
        k in limits and v <= limits[k] for k, v in compared.items())
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": card.device_block(device, cell["chips"])}
    result["device"]["memory_peak_bytes"] = out["memory_peak_bytes"]
    if args.trace and run.profile is not None:
        result["device"]["busy_s"] = run.profile.busy_s
        result["device"]["window_s"] = run.profile.window_s
        result["breakdown"] = {"device_ops": run.profile.device_ops,
                               "idle_gaps": run.profile.idle_gaps}
    result["compared"] = {k: {"value": v, "limit": limits.get(k)}
                          for k, v in compared.items()}
    print("info " + json.dumps(run.info, default=str), flush=True)
    for k, v in compared.items():
        print(f"compared {k} {v!r} limit {limits.get(k)!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return result

