"""Profiling harnesses: stage breakdown, solve breakdown, PPO iteration
breakdown, batch-size sweep, torch.profiler trace.

The port of the JAX package's ``tools/profiling.py`` (the reference's
per-phase wall-clock prints and Gantt plotter: src/profile_dpenv.py,
src/profile_subproc_dpenv.py:1-24, src/plot_profiling.py:831-868):

1. ``stage_breakdown``: a batch env step's host time by stage, timed in
   place by the program's spans (``utils/tracing.py``), on the step's
   eager method (``step_auto_reset_eager``): a step replayed as CUDA
   graphs (``envs/graphs.py``) has no stage spans.
2. ``solve_breakdown``: the stages inside the forward pass.
3. ``train_breakdown``: a PPO iteration's rollout, and full iterations
   at 1 and ``epochs`` epochs, so the per-epoch cost is the slope.
4. ``throughput_sweep``: rollout env-steps/s at several batch sizes.
5. ``trace``: a batch rollout under ``torch.profiler``: a Chrome trace
   and the ``key_averages`` table. It runs under
   ``utils.tracing.collect(annotate=True)``, so the trace's CPU and GPU
   rows name the program's stages: ``env.step`` and under it
   ``env.physics`` (``engine.kinematics``, ``engine.collision``,
   ``engine.dynamics``, ``engine.constraints`` with ``engine.solve``,
   ``engine.integrate``), ``env.obs``, ``env.reward``, ``env.done`` and
   ``env.reset`` (the full list: ``utils/tracing.py``). On the card the
   steps are the graphs' replays (captured in the warm-up, before the
   profiler starts): ``env.step`` with ``engine.solve`` between two
   graph launches, their kernels on the GPU rows.

On the card every timing is taken around a loop that ends in
``torch.cuda.synchronize()``, after a warm-up (for a rollout, the steps
that capture its graphs); on the CPU the same code times the plain
versions, which says nothing of the card.

Usage: python -m deepmimic_mujoco_tpu_torch.tools.profiling
           [--mode stages|solve|sweep|trace|train] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from deepmimic_mujoco_tpu_torch.envs.graphs import WARMUP_CALLS


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _bench(fn, *args, iters=10, device="cuda"):
    """(seconds per call, fused-solve launches per call) of fn(*args),
    after one warm-up call."""
    from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs

    with torch.no_grad():
        fn(*args)
        _sync(device)
        n0 = fs.fused_solve.launches
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        _sync(device)
        dt = (time.perf_counter() - t0) / iters
    return dt, (fs.fused_solve.launches - n0) / iters


def _reset(env, batch, seed=0):
    g = torch.Generator(device=env.device).manual_seed(seed)
    with torch.no_grad():
        return env.reset(batch, generator=g), g


def stage_breakdown(env, batch: int = 1024, steps: int = 8):
    """Rows (stage, host ms a step) of ``steps`` batch env steps (the
    eager method, each stage in its span) timed in place by the
    program's spans under ``tracing.collect()``: first
    ``env.step`` whole, then each ``env.*`` and ``engine.*`` stage's
    self time (its spans less the spans inside them, summed within a
    step), the median over the steps."""
    import statistics

    from deepmimic_mujoco_tpu_torch.utils import tracing

    dev = env.device
    (states, _), g = _reset(env, batch)
    a = torch.zeros(batch, env.action_size, device=dev)
    with torch.no_grad():
        states, _ = env.step_auto_reset_eager(states, a, g)   # warm-up
        _sync(dev)
        tracing.reset()
        with tracing.collect():
            for _ in range(steps):
                with tracing.span("env.step"):
                    states, _ = env.step_auto_reset_eager(states, a, g)
                _sync(dev)
    spans = tracing.snapshot().spans
    tracing.reset()
    inner = {}
    for s in spans:
        if s.parent is not None:
            inner[s.parent] = inner.get(s.parent, 0) + s.end_ns - s.start_ns
    per_step = {}       # step's root id -> {stage: self ns}
    for s in spans:
        stage = per_step.setdefault(s.root, {})
        stage[s.name] = (stage.get(s.name, 0) + s.end_ns - s.start_ns
                         - (0 if s.name == "env.step" else inner.get(s.id, 0)))
    names = ["env.step"] + sorted({n for st in per_step.values() for n in st}
                                  - {"env.step"})
    rows = []
    for name in names:
        ms = statistics.median(st.get(name, 0) / 1e6
                               for st in per_step.values())
        rows.append((name, ms))
        print(f"{name:>18}: {ms:8.2f} ms a step", flush=True)
    return rows


def solve_breakdown(env, batch: int = 4096):
    """Substage timing inside the forward pass: the position stage, the
    contact-Jacobian parts, CRBA + RNE, the full constraint solve and
    the engine's forward; each row runs everything before it too."""
    from deepmimic_mujoco_tpu_torch.physics import dynamics
    from deepmimic_mujoco_tpu_torch.physics.kinematics import com_vel
    from deepmimic_mujoco_tpu_torch.physics.solver import (
        contact_jac_parts, solve_constraints,
    )

    m, eng, dev = env.model, env.engine, env.device
    (states, _), _ = _reset(env, batch)
    q, v = states.qpos, states.qvel
    u = torch.zeros(batch, m.nu, device=dev)

    def position(qi):
        _, com, contacts = eng.position_stage(qi)
        return com, contacts

    def parts(qi):
        com, contacts = position(qi)
        return contact_jac_parts(m, com, contacts, eng.body_dof)

    def crb_rne(qi, vi):
        com, _ = position(qi)
        cvel, cdof_dot = com_vel(m, com, vi)
        return dynamics.crb(m, com), dynamics.rne(m, com, cvel, cdof_dot,
                                                  vi)

    def solve(qi, vi, ui):
        com, contacts = position(qi)
        cvel, cdof_dot = com_vel(m, com, vi)
        Mm = dynamics.crb(m, com)
        qf = (dynamics.actuator_force(m, ui)
              - dynamics.rne(m, com, cvel, cdof_dot, vi))
        return solve_constraints(
            m, com, Mm, qf, qi, vi, contacts, eng.body_dof, eng.limit_table,
            iterations=eng.iterations, cone=eng.cone).qacc

    stages = {
        "position (fk+com+coll)": (position, (q,)),
        "+ jac parts": (parts, (q,)),
        "+ crb + rne": (crb_rne, (q, v)),
        "+ full solve": (solve, (q, v, u)),
        "forward (engine)": (lambda a, b, c: eng.forward(a, b, c).qacc,
                             (q, v, u)),
    }
    rows = []
    for name, (fn, args) in stages.items():
        dt, launches = _bench(fn, *args, device=dev)
        rows.append((name, dt * 1e3, batch / dt, launches))
        print(f"{name:>24}: {dt * 1e3:8.2f} ms/batch "
              f"({batch / dt:12,.0f} env-evals/s; {launches:g} kernel "
              f"launches)", flush=True)
    return rows


def train_breakdown(env, n_envs: int = 2048, horizon: int = 64,
                    epochs: int = 20, minibatch: int = 4096, iters: int = 5):
    """PPO iteration phase breakdown: the rollout alone, and full
    iterations at 1 and ``epochs`` epochs, so the per-epoch cost (the
    minibatch gathers, gradients and Adam steps) falls out of the slope.
    Profiled hyperparams: 20 epochs / minibatch 4096 (reference:
    src/sb3_ppo.py:253-265)."""
    from deepmimic_mujoco_tpu_torch.rl.ppo import PPO, PPOConfig

    dev = env.device
    B = n_envs * horizon
    rows = []

    def make(e):
        ppo = PPO(env, PPOConfig(n_envs=n_envs, horizon=horizon, epochs=e,
                                 minibatch_size=minibatch))
        return ppo, ppo.init(0)

    ppo, ts = make(1)
    ppo.rollout(ts)
    _sync(dev)
    t0 = time.perf_counter()
    ppo.rollout(ts)
    _sync(dev)
    dt_roll = time.perf_counter() - t0
    rows.append(("rollout only", dt_roll * 1e3, B / dt_roll))

    dts = {}
    for e in (1, epochs):
        ppo, ts = make(e)
        ppo.train_iter(ts)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            ppo.train_iter(ts)
        _sync(dev)
        dts[e] = (time.perf_counter() - t0) / iters
        rows.append((f"full iter ({e} epochs)", dts[e] * 1e3, B / dts[e]))

    per_epoch = (dts[epochs] - dts[1]) / max(epochs - 1, 1)
    gae_flat = dts[1] - dt_roll - per_epoch
    rows.append(("per epoch (slope)", per_epoch * 1e3,
                 B / max(per_epoch, 1e-9)))
    rows.append(("GAE+flatten (residual)", gae_flat * 1e3,
                 B / max(gae_flat, 1e-9)))
    n_mb = max(B // minibatch, 1)
    rows.append((f"per minibatch ({n_mb}/epoch)",
                 per_epoch / n_mb * 1e3, 0.0))
    for name, ms, sps in rows:
        print(f"{name:>24}: {ms:8.2f} ms ({sps:12,.0f} env-steps/s)",
              flush=True)
    return rows


def throughput_sweep(env, batches=(64, 256, 1024, 4096), steps: int = 64,
                     warmup: int = WARMUP_CALLS + 1):
    """Rows (batch, env-steps/s): ``steps`` steps of step_auto_reset
    under 0.1 x N(0, 1) actions, after ``warmup`` steps (by default the
    eager ones and the capture of the batch's graphs)."""
    dev = env.device
    results = []
    for b in batches:
        (states, _), g = _reset(env, b)
        with torch.no_grad():
            for i in range(warmup + steps):
                if i == warmup:
                    _sync(dev)
                    t0 = time.perf_counter()
                a = 0.1 * torch.randn(b, env.action_size, generator=g,
                                      device=dev)
                states, out = env.step_auto_reset(states, a, g)
            _sync(dev)
        sps = b * steps / (time.perf_counter() - t0)
        results.append((b, sps))
        print(f"batch {b:6d}: {sps:14,.0f} env-steps/s", flush=True)
    return results


def trace(env, out_dir: str = None, batch: int = 1024, steps: int = 32):
    """``steps`` steps of a batch rollout under torch.profiler (CPU and
    CUDA activities), the program's spans annotated: writes
    ``trace.json`` (Chrome trace) into ``out_dir`` and prints the
    key_averages table. Returns the path."""
    from torch.profiler import ProfilerActivity, profile

    from deepmimic_mujoco_tpu_torch.utils import tracing

    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "dm_torch_trace")
    os.makedirs(out_dir, exist_ok=True)
    dev = env.device
    (states, _), g = _reset(env, batch)
    a = torch.zeros(batch, env.action_size, device=dev)
    acts = [ProfilerActivity.CPU]
    if torch.device(dev).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch.no_grad():
        for _ in range(WARMUP_CALLS + 1):   # up to the graphs' capture
            states, out = env.step_auto_reset(states, a, g)
        _sync(dev)
        with profile(activities=acts) as prof, \
                tracing.collect(annotate=True):
            for _ in range(steps):
                states, out = env.step_auto_reset(states, a, g)
            _sync(dev)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    sort = ("self_cuda_time_total" if len(acts) > 1
            else "self_cpu_time_total")
    print(prof.key_averages().table(sort_by=sort, row_limit=25))
    print("Chrome trace written to", path)
    return path


def plot_results(rows, path: str, kind: str):
    """Bar chart of stage times or the throughput sweep (the reference
    renders its profiling logs as a Gantt chart,
    src/plot_profiling.py:831-868). Needs matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4))
    if kind == "stages":
        ax.barh([r[0] for r in rows], [r[1] for r in rows],
                color="tab:blue")
        ax.set_xlabel("host ms a batch step")
    else:
        ax.bar([str(r[0]) for r in rows], [r[1] for r in rows],
               color="tab:green")
        ax.set_xlabel("batch size")
        ax.set_ylabel("env-steps/s")
    fig.tight_layout()
    fig.savefig(path)
    print("plot saved to", path)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", default="stages",
                   choices=["stages", "solve", "sweep", "trace", "train"],
                   help="stages: host ms by stage of the eager step "
                        "(step_auto_reset_eager; a replayed step has no "
                        "stage spans); trace: a profile of the replayed "
                        "step")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--horizon", type=int, default=64)
    p.add_argument("--env", default="deep_mimic_mujoco",
                   choices=["deep_mimic_mujoco", "dp_combined_env"])
    p.add_argument("--motion", default="walk")
    p.add_argument("--robot", default="humanoid3d")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--plot", default=None,
                   help="save a chart of the results to this path")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from deepmimic_mujoco_tpu_torch.envs import DPCombinedEnv, DPEnv

    env = (DPEnv(motion=args.motion, robot=args.robot, device=args.device)
           if args.env == "deep_mimic_mujoco"
           else DPCombinedEnv(device=args.device))
    if args.mode == "stages":
        rows = stage_breakdown(env, args.batch)
        if args.plot:
            plot_results(rows, args.plot, "stages")
    elif args.mode == "solve":
        solve_breakdown(env, args.batch)
    elif args.mode == "train":
        train_breakdown(env, n_envs=args.batch, horizon=args.horizon,
                        epochs=args.epochs)
    elif args.mode == "sweep":
        rows = throughput_sweep(env)
        if args.plot:
            plot_results(rows, args.plot, "sweep")
    else:
        trace(env, batch=args.batch)


if __name__ == "__main__":
    main()
