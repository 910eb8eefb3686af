"""A profiled sub-window: torch.profiler over CPU and CUDA activity,
reduced to sums (no Chrome trace is kept), plus the fused solve's
inputs recorded while it runs.

What it yields (``Profile``): the window's length (first to last event,
the profiler's clock), the union of the device's kernel intervals, the
host's launch calls (the CUDA runtime and driver calls that enqueue
work), the device time of the fused-solve kernels, the device
operations that took most time, and the longest idle gaps of the device
labelled by the innermost host operation running at their middle.
"""
import contextlib

import numpy as np

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cuLaunchCooperativeKernel", "cudaGraphLaunch",
                "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cuMemcpyAsync", "cuMemsetD8Async", "cuMemsetD32Async")
SOLVE_KERNEL = "fused_solve"


class Profile:
    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.launches = 0
        self.kernels = 0
        self.solve_kernel_s = []      # device time of each solve launch
        self.nccl_kernel_s = 0.0      # device time of the collectives
        self.solves = []              # (nv, K, L, iterations, active)
        self.device_ops = []
        self.idle_gaps = []
        self.env_steps = 0            # batched env-step calls profiled
        self.work = {}                # policy and update samples counted


def _union(starts, ends):
    order = np.argsort(starts)
    s, e = starts[order], ends[order]
    merged = []
    cs, ce = s[0], e[0]
    for a, b in zip(s[1:], e[1:]):
        if a > ce:
            merged.append((cs, ce))
            cs, ce = a, b
        else:
            ce = max(ce, b)
    merged.append((cs, ce))
    return merged


def summarize(events, prof: Profile):
    from torch.autograd import DeviceType

    dev, host = [], []
    launches = 0
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            dev.append((e.name(), e.start_ns(), e.duration_ns()))
        else:
            name = e.name()
            if name in LAUNCH_CALLS:
                launches += 1
            elif not name.startswith(("cuda", "cu")):
                host.append((name, e.start_ns(), e.duration_ns()))
    prof.launches = launches
    ts = [s for _, s, _ in dev] + [s for _, s, _ in host]
    te = [s + d for _, s, d in dev] + [s + d for _, s, d in host]
    if not ts:
        return prof
    w0, w1 = min(ts), max(te)
    prof.window_s = (w1 - w0) / 1e9
    if not dev:
        return prof
    prof.kernels = len(dev)
    starts = np.array([s for _, s, _ in dev], np.int64)
    ends = starts + np.array([d for _, _, d in dev], np.int64)
    merged = _union(starts, ends)
    prof.busy_s = sum(b - a for a, b in merged) / 1e9
    by_name = {}
    for name, _, d in dev:
        by_name[name] = by_name.get(name, 0) + d
        if SOLVE_KERNEL in name:
            prof.solve_kernel_s.append(d / 1e9)
        if "nccl" in name.lower():
            prof.nccl_kernel_s += d / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    prof.device_ops = [[n[:160], d / 1e9] for n, d in top]
    bounds = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = sorted(((bounds[i + 1] - bounds[i], bounds[i])
                   for i in range(0, len(bounds) - 1, 2)),
                  reverse=True)[:10]
    hs = np.array([s for _, s, _ in host], np.int64)
    he = hs + np.array([d for _, _, d in host], np.int64)
    for length, start in gaps:
        if length <= 0:
            continue
        mid = start + length // 2
        cover = np.nonzero((hs <= mid) & (he >= mid))[0]
        label = ("no host op" if not len(cover) else
                 host[cover[np.argmin((he - hs)[cover])]][0][:160])
        prof.idle_gaps.append([label, length / 1e9])
    return prof


@contextlib.contextmanager
def record_solves(prof: Profile):
    """Keep the inputs' activity of each fused-solve call (the port's
    main-path entry, as ``physics/solver.py`` calls it) while the block
    runs; nothing is computed on them until the profile is read."""
    from deepmimic_mujoco_tpu_torch.physics import solver

    entry = solver.fused_solve_parts

    def recorded(M, *args, **kw):
        active = args[9]
        prof.solves.append((M.shape[1], kw["K"], kw["L"], kw["iterations"],
                            active))
        return entry(M, *args, **kw)

    solver.fused_solve_parts = recorded
    try:
        yield
    finally:
        solver.fused_solve_parts = entry


@contextlib.contextmanager
def profiled(device, prof: Profile):
    """Profile the block (CPU and CUDA activity), synchronised at both
    ends, into ``prof``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = str(device).startswith("cuda")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as p:
        with record_solves(prof):
            yield prof
        if cuda:
            torch.cuda.synchronize()
    summarize(p.profiler.kineto_results.events(), prof)


def solve_active(prof: Profile):
    """Per recorded solve call: (nv, K, L, iterations, active contacts per
    env, active limit rows per env) as numpy."""
    out = []
    for nv, K, L, iters, active in prof.solves:
        a = active.detach().to("cpu").numpy()
        out.append((nv, K, L, iters, a[:, :K].sum(1), a[:, 3 * K:].sum(1)))
    return out
