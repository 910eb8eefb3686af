"""The readings the limits of ``correct`` are set from (not part of a
benchmark run):

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        [--control] [--faults half_batch,altered_reward] [--out FILE] \
        [--size warmup_iters=1]

For each seed it drives the cell's set-up and a short window in one
process, and prints one JSON line with the program's compared numbers,
with ``--control`` those of the control (the reference in float32 with
TF32 matmuls in the program's place, from the same inputs), and with
``--faults`` those of the program with each named fault planted.

Each fault is a file ``faults/<name>.py``, planted by ``bmk.faults``;
the faults a cell must fail are its driver's ``FAULTS``
(``drivers/<driver>.py``). A data-parallel cell's control is read on
rank 0 (``bmk/dp.py``) and comes back with its result.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None, device="cuda", sizes=None):
    from bmk import card, faults, spec
    from bmk.run import Run, cache_dirs

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default=None)
    p.add_argument("--size", action="append", default=[],
                   help="key=value: a traffic size to override, e.g. "
                        "warmup_iters=1")
    args = p.parse_args(argv)
    sizes = dict(sizes or {})
    for kv in args.size:
        k, v = kv.split("=")
        sizes[k] = int(v)
    cache_dirs()
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    card.require(cell["chips"], device)
    traffic = spec.traffic(cell["traffic"])
    driver = spec.module("drivers", traffic["driver"])
    lines = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        for f in [""] + [x for x in args.faults.split(",") if x]:
            run = Run(name=cell["name"], cell=cell,
                      config=spec.config(bench, cell["config"]),
                      traffic=traffic, seed=seed, seconds=args.seconds,
                      trace=False, device=device, t0=time.time(),
                      sizes=dict(sizes))
            run.info.update(fault=f or None, control=args.control)
            with faults.fault(f):
                out = driver.run(run)
            line = dict(cell=cell["name"], seed=seed, fault=f or None,
                        program=out["compared"],
                        quantiles=run.info.get(
                            "step_gap_quantiles.program"))
            if args.control and not f:
                line["control"] = out.get("control") or driver.check(
                    run, run.caps, "tf32")
                line["control_quantiles"] = run.info.get(
                    "step_gap_quantiles.tf32")
            if device != "cpu":
                line["card"] = card.smi()
            print(json.dumps(line), flush=True)
            lines.append(line)
    if args.out:
        with open(args.out, "w") as fh:
            for line in lines:
                fh.write(json.dumps(line) + "\n")
    return lines


if __name__ == "__main__":
    main()
