"""Fused mass-matrix solve + constraint solve: CUDA kernel and plain torch.

Replaces the TPU kernel ``deepmimic_mujoco_tpu/ops/fused_solve.py:
_fused_kernel`` (dispatched by ``_solve_lanes``). Per env, in fp32:

  1. Cholesky  M = L L^T
  2. W = L^-1 J^T
  3. y = L^-1 qfrc_smooth (qacc_smooth = L^-T y)
  4. diagA = sum_k W_k^2, R = (1-imp)/imp diagA, b = W^T y - aref
  5. 12 masked power iterations -> step = min(1.5/lambda_max, 1)
  6. ``iterations`` projected diagonal-scaled gradient sweeps from
     project(lam0), with Ahat v = W^T (W v) + R v; the projection is the
     elliptic cone on the K contacts (or the L1 diamond when
     ``pyramidal``), limit rows clamped to >= 0, all masked by active
  7. qacc = L^-T (y + W lam), qfrc = L (W lam) = J^T lam, and lam.

The step rule, power iterations, projection (with the 1e-24 inside the
tangent norm), the 1e-8 / 1e-12 clamps, the iteration count and the warm
start through project(lam0) copy ``physics/solver.py:_pgs_iterate`` of
the JAX package exactly: solver output is semantics (a shifted warm
start moved the walk gate from 339 to 27).

Two entries: ``fused_solve`` takes an explicit J^T (B, nv, n);
``fused_solve_parts`` (the main path) takes the contact-Jacobian parts,
and on the card the kernel builds the rows of J from them in its load
phase, so J^T never reaches device memory. Both take the plain version
for CPU tensors and launch the kernel (``csrc/fused_solve.cu``) for CUDA
tensors; there is no fallback between them. On the CPU the parts entry
is ``build_jt`` + the plain version, as the JAX package builds J^T in
XLA outside its Pallas kernel. The kernel is built with nvcc into
``build/torch_kernels/libfused_solve.so`` at first use and bound with
ctypes; ``build_all`` builds the phase-clock variant beside it.

The register plans hold up to 112 constraint rows (humanoid3d to 28
contact slots, G1 to 25). Beyond them, up to what one block's shared
memory holds (``check_fits`` names the largest ``max_contacts``), the
kernel's shared-memory plan runs the same pipeline on the same kind of
thread grid, 128 threads an env, with each thread's W split between
registers (its first contacts) and shared memory (the rest), as many
columns a thread as K and L ask for (``launch_plan``, ``plan_cells``).

What bounds it on the H100: at humanoid3d size (nv 34, n 76) an env
moves ~17 KB (explicit J^T; ~10 KB from the parts) and does ~0.78
MFLOP, so the fp32 rate sets the bound (``bound_ms``). The kernel keeps
W in registers for all 63 matvecs: the threads of an env form a
TR x TC grid (``launch_plan``) in which each owns RPT rows and a fixed
set of columns (the normal and both tangent rows of its contacts, then
its limit rows); W v and W^T u reduce with warp shuffles, and the cone
projection runs in registers. See the source for the rest.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from typing import NamedTuple

import numpy as np
import torch

from deepmimic_mujoco_tpu_torch.utils import tracing

POWER_ITERS = 12  # matches physics/solver.py:_pgs_iterate
# the register plans' range (csrc/fused_solve.cu:REG_NV_MAX ...); larger
# sizes take the shared-memory plan
REG_NV_MAX = 48
REG_N_MAX = 112
REG_K_MAX = 37

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "fused_solve.cu")
BUILD_DIR = os.path.join(_REPO, "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# translation units per library (csrc/fused_solve.cu:FS_SHARDS): each
# builds a share of the plans, all in parallel, then one link
UNITS = 4
# library name -> extra nvcc flags: the kernel, and its phase-clock twin
VARIANTS = {"fused_solve": [],
            "fused_solve_clocks": ["-DFUSED_SOLVE_CLOCKS"]}

_libs = {}
_lib_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the fused-solve kernel is built "
                       "from csrc/fused_solve.cu at first use")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build_all(force: bool = False, names=tuple(VARIANTS)) -> dict:
    """Compile csrc/fused_solve.cu into each named shared library (when
    missing, older than the source, or ``force``): ``UNITS`` nvcc
    processes per library, each building its share of the plans into an
    object file, all started together, then one link per library.
    Returns {name: path}; raises with nvcc's output when a build fails.
    ptxas's resource report (registers, shared memory, spills per
    kernel) is kept in ``build_all.ptxas[name]``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if (not force and os.path.exists(out)
                and os.path.getmtime(out) >= os.path.getmtime(SOURCE)):
            continue
        for u in range(UNITS):
            obj = f"{out}.{os.getpid()}.{u}.o"
            cmd = [_nvcc(), *NVCC_FLAGS, *VARIANTS[name],
                   f"-DFS_SHARDS={UNITS}", f"-DFS_SHARD={u}", "-c", "-o",
                   obj, SOURCE]
            procs[name, u] = (cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    failed, logs, objs = [], {}, {}
    for (name, u), (cmd, obj, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{log}")
        logs.setdefault(name, []).append(log.strip())
        objs.setdefault(name, []).append(obj)
    for name in objs:
        if not failed:
            out = _lib_path(name)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), "-shared", "-o", tmp, *objs[name]]
            link = subprocess.run(cmd, capture_output=True, text=True)
            if link.returncode != 0:
                failed.append(f"nvcc link failed ({link.returncode}): "
                              f"{' '.join(cmd)}\n{link.stdout}"
                              f"{link.stderr}")
            else:
                build_all.ptxas[name] = "\n".join(logs[name])
                os.replace(tmp, out)
        for obj in objs[name]:
            if os.path.exists(obj):
                os.remove(obj)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _lib_path(name) for name in names}


build_all.ptxas = {}


def _load(clocks: bool = False):
    name = "fused_solve_clocks" if clocks else "fused_solve"
    with _lib_lock:
        if name not in _libs:
            with tracing.setup("setup.kernel"):
                lib = ctypes.CDLL(build_all(names=(name,))[name])
            fn = lib.fused_solve_launch
            fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 13
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            info = lib.fused_solve_info
            info.argtypes = [ctypes.c_int] * 10 + [ctypes.c_void_p]
            info.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


# ---------------- launch plan ---------------------------------------------

# (TR, TC, RPT, KC, LC) of every register plan the kernel is compiled
# for, in the order they are tried: csrc/fused_solve.cu:FUSED_SOLVE_PLANS.
PLANS = ((4, 8, 9, 2, 4), (4, 16, 11, 2, 3), (4, 32, 12, 2, 2))
# the shared-memory plan's instances (TR, TC, RPT, KR, LR): the register
# grid, the rows per thread, and the contacts and limit rows per column
# group whose W stays in registers (the rest lies in shared memory), in
# the order they are tried: csrc/fused_solve.cu:FUSED_SOLVE_SHARED
SHARED_PLANS = ((4, 32, 9, 2, 1), (4, 32, 11, 1, 2), (4, 32, 11, 2, 0),
                (4, 32, 16, 1, 0))
W_REGS_BUDGET = 112        # W values one thread holds in registers
SMEM_PER_BLOCK = 232_448   # H100: most shared memory one block can use
THREADS_PER_BLOCK = 1024


class LaunchPlan(NamedTuple):
    """How the kernel lays one env over its threads: thread tid of an env
    is (rg, cg) = (tid % tr, tid // tr); it holds W[rg + tr s, col] for
    s < rpt and its columns (``plan_cells``). In a register plan all of
    them lie in registers; in the shared-memory plan (``shared``) its
    first kc contacts and lc limit rows do and the rest lie in shared
    memory."""
    tr: int                 # row groups
    tc: int                 # column groups
    rpt: int                # rows per thread
    kc: int                 # contacts per column group (in registers)
    lc: int                 # limit rows per column group (in registers)
    shared: bool            # W split between registers and shared memory
    threads_per_env: int
    envs_per_block: int
    threads_per_block: int
    cols_per_thread: int    # all of a thread's columns, pads included
    w_regs: int             # W values per thread in registers
    smem_bytes: int         # dynamic shared memory per block

    @property
    def label(self) -> str:
        return (f"shared {self.tr} x {self.tc}, {self.rpt} x "
                f"{3 * self.kc + self.lc} in registers" if self.shared
                else f"{self.tr} x {self.tc}")


def _units(n_units: int, tc: int, base: int) -> int:
    """Slots of one kind a column group holds past its ``base`` register
    slots: ceil(n_units / tc) - base, at least 0."""
    return max(-(-n_units // tc) - base, 0)


def _shared_cols(K: int, L: int, plan) -> int:
    """Columns a thread of the shared-memory plan ``plan`` holds in shared
    memory: 3 per contact slot and 1 per limit slot past its register
    slots."""
    tc, kr, lr = plan[1], plan[3], plan[4]
    return 3 * _units(K, tc, kr) + _units(L, tc, lr)


def shared_smem_bytes(nv: int, n: int, K: int, plan) -> int:
    """Dynamic shared memory of one env in the shared-memory plan
    ``plan`` (a ``SHARED_PLANS`` entry; csrc/fused_solve.cu:
    Split::floats): the column constants of every slot, W's shared part
    and each thread's slots of the vector it multiplies, mu of every
    contact slot, then L, three nv-vectors and two buffers of the warps'
    partials (16 rows a row group; the Cholesky's column buffers and
    trash line use them first)."""
    tr, tc, rpt, kr, lr = plan[:5]
    t = tr * tc
    qs = _units(K, tc, kr)
    sc = _shared_cols(K, n - 3 * K, plan)
    return 4 * (4 * tc * (3 * kr + lr + sc) + sc * (rpt * t + t)
                + (kr + qs) * tc + nv * (nv | 1) + 3 * nv
                + 2 * (t // 32) * tr * 16)


@functools.lru_cache(maxsize=None)
def launch_plan(nv: int, n: int, K: int) -> LaunchPlan:
    """The first of ``PLANS`` that holds (nv, K, L = n - 3K) within the
    register plans' range, else an instance of ``SHARED_PLANS`` (below)
    if one env fits one block's shared memory; raises a ValueError
    otherwise.

    One env per block: an env of one warp synchronises with __syncwarp,
    and a block of one env needs no named barriers; the registers (220
    a thread at humanoid3d: 8 one-warp envs per SM) rather than the
    block count limit residency. The register plans are the first that
    fit humanoid3d (one warp) and G1 (two warps), then one for the
    largest sizes they take. The shared-memory plan takes 128 threads an
    env whatever K; its instances differ in rows per thread (humanoid3d,
    G1, up to 64 dofs) and in which of a thread's contacts and limit
    rows stay in registers: of those with the fewest rows that hold nv,
    the one that leaves the fewest columns in shared memory (G1 up to 32
    contact slots holds all of W in registers with one contact and two
    limit rows a thread; past that, two contacts). The shared-memory
    sums are csrc/fused_solve.cu:Smem::floats and Split::floats."""
    L = n - 3 * K
    if nv < 1 or K < 0 or L < 0:
        raise ValueError(f"fused_solve: no system with nv={nv}, n={n}, "
                         f"K={K}")
    if nv <= REG_NV_MAX and n <= REG_N_MAX and K <= REG_K_MAX:
        for tr, tc, rpt, kc, lc in PLANS:
            if nv <= tr * rpt and K <= tc * kc and L <= tc * lc:
                return _register_plan(nv, n, tr, tc, rpt, kc, lc)
    rows = [p[0] * p[2] for p in SHARED_PLANS if nv <= p[0] * p[2]]
    if not rows:
        raise ValueError(
            f"fused_solve kernel: nv={nv} dofs, more than the "
            f"{max(p[0] * p[2] for p in SHARED_PLANS)} rows of any plan")
    # the instances of the fewest rows that hold nv, the fewest shared
    # columns first (the first of a tie)
    fits = sorted((p for p in SHARED_PLANS if p[0] * p[2] == min(rows)),
                  key=lambda p: _shared_cols(K, L, p))
    smem = [shared_smem_bytes(nv, n, K, p) for p in fits]
    if min(smem) > SMEM_PER_BLOCK:
        raise ValueError(
            f"fused_solve kernel: nv={nv}, n={n}, K={K} needs {min(smem)} "
            f"B of shared memory per env, more than one block's "
            f"{SMEM_PER_BLOCK} B")
    i = next(i for i, b in enumerate(smem) if b <= SMEM_PER_BLOCK)
    tr, tc, rpt, kr, lr = fits[i]
    smem = smem[i]
    t = tr * tc
    cr = 3 * kr + lr
    return LaunchPlan(tr, tc, rpt, kr, lr, True, t, 1, t,
                      cr + _shared_cols(K, L, fits[i]), rpt * cr, smem)


def _register_plan(nv, n, tr, tc, rpt, kc, lc) -> LaunchPlan:
    t = tr * tc
    nw = t // 32
    cpt = 3 * kc + lc
    mc = -(-tr * rpt // tc)                 # M columns per thread
    smem = 4 * (4 * tc * (cpt | 1)          # column constants (float4)
                + nv * (n | 1)              # J^T, staged
                + nv * (nv | 1) + 3 * nv    # L, 1/L_kk, y, t
                + 2 * max(tr * rpt, tc * mc)            # Cholesky columns
                + (2 * nw * tr * rpt if nw > 1 else 0)   # warp partials
                + t + tr * rpt)             # non-owners' Cholesky stores
    return LaunchPlan(tr, tc, rpt, kc, lc, False, t, 1, t, cpt, rpt * cpt,
                      smem)


def max_contacts_on_card(nv: int, L: int):
    """The largest K (contact slots) whose env the kernel holds with nv
    dofs and L limit rows, or None when not even K = 0 fits. The shared
    memory an env needs grows with K, so the first K that does not fit
    ends the search."""
    k = -1
    while _holds(nv, 3 * (k + 1) + L, k + 1):
        k += 1
    return k if k >= 0 else None


def check_fits(nv: int, K: int, L: int) -> LaunchPlan:
    """The launch plan of an engine's solve (nv dofs, K contact slots, L
    limit rows); a ValueError that names the limit when the kernel holds
    no such env: the card's path has no plain fallback. The CPU path
    (the plain version) takes any size."""
    try:
        return launch_plan(nv, 3 * K + L, K)
    except ValueError as e:
        k_max = max_contacts_on_card(nv, L)
        hint = (f"at most max_contacts={k_max} with nv={nv}, L={L}"
                if k_max is not None else
                f"no max_contacts fits nv={nv}, L={L}")
        raise ValueError(
            f"the fused-solve kernel on the card holds an env whose "
            f"shared-memory plan fits one block ({SMEM_PER_BLOCK} B); this "
            f"engine needs nv={nv}, K={K}, L={L} (3*K + L = {3 * K + L}): "
            f"{hint}. The CPU path has no such limit. ({e})") from None


def _holds(nv, n, K):
    try:
        launch_plan(nv, n, K)
    except ValueError:
        return False
    return True


def plan_cells(plan: LaunchPlan, nv: int, K: int, L: int):
    """(tid, row, col, in_registers) for every entry of W a thread of the
    env holds (csrc/fused_solve.cu: col_of in each kernel); pad slots are
    left out. A register plan deals contact c = cg + tc q and limit row
    l = cg + tc p; the shared-memory plan deals limit rows from the last
    column group, l = tc - 1 - cg + tc p, and keeps its first kc contacts
    and lc limit rows in registers."""
    n_q = -(-K // plan.tc) if plan.shared else plan.kc
    n_p = -(-L // plan.tc) if plan.shared else plan.lc
    for tid in range(plan.threads_per_env):
        rg, cg = tid % plan.tr, tid // plan.tr
        cols = []
        for q in range(n_q):
            c = cg + plan.tc * q
            cols += [(r * K + c, q < plan.kc) for r in range(3) if c < K]
        for p in range(n_p):
            lim = (plan.tc - 1 - cg if plan.shared else cg) + plan.tc * p
            if lim < L:
                cols.append((3 * K + lim, p < plan.lc))
        for s in range(plan.rpt):
            row = rg + plan.tr * s
            if row < nv:
                yield from ((tid, row, c, reg) for c, reg in cols)


def kernel_info(nv: int, n: int, K: int, parts: bool = True) -> dict:
    """Registers and local (spill) bytes per thread of the plan's kernel,
    its dynamic shared bytes and the blocks per SM that
    cudaOccupancyMaxActiveBlocksPerMultiprocessor reports (card only)."""
    plan = launch_plan(nv, n, K)
    out = (ctypes.c_int * 4)()
    err = _load().fused_solve_info(*plan[:6], int(parts), nv, n, K, out)
    if err != 0:
        raise RuntimeError(f"fused_solve_info failed: cudaError {err}")
    return {"plan": plan, "regs": out[0], "spill_bytes": out[1],
            "smem_bytes": out[2], "blocks_per_sm": out[3]}


# ---------------- plain torch version -----------------------------------

def _project(lam, mu, active, K, pyramidal):
    nrm = torch.clamp(lam[:, :K], min=0.0)
    t1 = lam[:, K:2 * K]
    t2 = lam[:, 2 * K:3 * K]
    lim = mu * nrm
    if pyramidal:
        # tangent-aligned 4-edge pyramid (mujoco200 PGS): L1 diamond
        # |t1|+|t2| <= mu*n, Euclidean projection per quadrant
        a1, a2 = torch.abs(t1), torch.abs(t2)
        x = torch.minimum(torch.clamp((a1 - a2 + lim) * 0.5, min=0.0), lim)
        over = a1 + a2 > lim
        p1 = torch.where(over, x, a1)
        p2 = torch.where(over, lim - x, a2)
        t1s, t2s = torch.sign(t1) * p1, torch.sign(t2) * p2
    else:
        tn = torch.sqrt(t1 * t1 + t2 * t2 + 1e-24)
        scale = torch.where(tn > lim, lim / tn, 1.0)
        t1s, t2s = t1 * scale, t2 * scale
    rest = torch.clamp(lam[:, 3 * K:], min=0.0)
    return torch.cat([nrm, t1s, t2s, rest], 1) * active


def fused_solve_plain(M, JT, qf, aref, imp, active, mu, lam0, *, K: int,
                      L: int, iterations: int, pyramidal: bool = False):
    """Plain torch version of the kernel: the same function, batched.
    M (B, nv, nv), JT (B, nv, n), qf (B, nv), aref/imp/active/lam0
    (B, n), mu (B, K). Returns (qacc, qfrc, lam)."""
    Lc, _ = torch.linalg.cholesky_ex(M)   # no raise, like the kernel
    W = torch.linalg.solve_triangular(Lc, JT, upper=False)      # (B, nv, n)
    y = torch.linalg.solve_triangular(Lc, qf[..., None], upper=False)[..., 0]
    imp = torch.clamp(imp, 1e-5, 1 - 1e-5)
    diagA = torch.clamp((W * W).sum(1), min=1e-8)
    R = (1.0 - imp) / imp * diagA
    inv_diag = 1.0 / torch.clamp(diagA + R, min=1e-8)
    b = (W * y[..., None]).sum(1) - aref

    def matvec(v):                                  # Ahat @ v
        u = (W @ v[..., None])[..., 0]              # (B, nv) = W v
        return (W.transpose(1, 2) @ u[..., None])[..., 0] + R * v

    def norm(v):
        return torch.sqrt((v * v).sum(1, keepdim=True))

    vec = active / torch.clamp(norm(active), min=1e-12)
    for _ in range(POWER_ITERS):
        w = inv_diag * matvec(vec * active) * active
        vec = w / torch.clamp(norm(w), min=1e-12)
    w = inv_diag * matvec(vec * active) * active
    lam_max = torch.clamp(norm(w), min=1.0)
    step = torch.clamp(1.5 / lam_max, max=1.0)

    lam = _project(lam0, mu, active, K, pyramidal)
    for _ in range(iterations):
        grad = matvec(lam) + b
        lam = _project(lam - step * inv_diag * grad, mu, active, K,
                       pyramidal)

    t = (W @ lam[..., None])[..., 0]
    qacc = torch.linalg.solve_triangular(
        Lc.transpose(1, 2), (y + t)[..., None], upper=True)[..., 0]
    qfrc = (Lc @ t[..., None])[..., 0]
    return qacc, qfrc, lam


# ---------------- wrapper -----------------------------------------------

def _check(name, x, shape, device, dtype=torch.float32):
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")


def _check_vectors(B, nv, n, K, dev, qf, aref, imp, active, mu, lam0):
    for name, x, shape in (("qf", qf, (B, nv)), ("aref", aref, (B, n)),
                           ("imp", imp, (B, n)), ("active", active, (B, n)),
                           ("mu", mu, (B, K)), ("lam0", lam0, (B, n))):
        _check(name, x, shape, dev)


def _launch(lib, plan, B, nv, K, L, iterations, pyramidal, M, JT, parts,
            vectors, clocks=None, stream=None):
    """One kernel launch; ``JT`` None selects the parts path. All tensors
    are contiguous and on one device. Returns (qacc, qfrc, lam)."""
    n = 3 * K + L
    dev = M.device
    qacc = torch.empty(B, nv, dtype=torch.float32, device=dev)
    qfrc = torch.empty(B, nv, dtype=torch.float32, device=dev)
    lam = torch.empty(B, n, dtype=torch.float32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    parts_ptrs = [None] * 7 if parts is None else [ptr(x) for x in parts]
    if stream is None:
        stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fused_solve_launch(
        ptr(M), ptr(JT), *parts_ptrs, *[ptr(x) for x in vectors],
        ptr(qacc), ptr(qfrc), ptr(lam), ptr(clocks), B, nv, n, K, L,
        int(iterations), int(bool(pyramidal)), *plan[:6], stream)
    if err != 0:
        raise RuntimeError(f"fused_solve kernel launch failed: "
                           f"cudaError {err}")
    return qacc, qfrc, lam


def fused_solve(M, JT, qf, aref, imp, active, mu, lam0, *, K: int, L: int,
                iterations: int, pyramidal: bool = False):
    """Batched fused solve from an explicit J^T (B, nv, n). CPU tensors
    take ``fused_solve_plain``; CUDA tensors launch the kernel (or
    raise). ``fused_solve.launches`` counts kernel launches of both
    entries, ``fused_solve.launches_by_thread`` counts them by the
    launching thread's ident and ``fused_solve.launches_by_plan`` by the
    plan's ``label``."""
    B, nv, n = JT.shape
    if n != 3 * K + L:
        raise ValueError(f"n={n} rows, expected 3*K+L={3 * K + L}")
    dev = JT.device
    _check("M", M, (B, nv, nv), dev)
    _check("JT", JT, (B, nv, n), dev)
    _check_vectors(B, nv, n, K, dev, qf, aref, imp, active, mu, lam0)
    if dev.type == "cpu":
        return fused_solve_plain(M, JT, qf, aref, imp, active, mu, lam0,
                                 K=K, L=L, iterations=iterations,
                                 pyramidal=pyramidal)
    if dev.type != "cuda":
        raise ValueError(f"fused_solve: unsupported device {dev}")
    plan = launch_plan(nv, n, K)
    if not B:
        return (M.new_empty(0, nv), M.new_empty(0, nv), M.new_empty(0, n))
    vectors = [x.contiguous() for x in (qf, aref, imp, active, mu, lam0)]
    with torch.cuda.device(dev):
        out = _launch(_load(), plan, B, nv, K, L, iterations, pyramidal,
                      M.contiguous(), JT.contiguous(), None, vectors)
    _count_launch(plan)
    return out


fused_solve.launches = 0
fused_solve.launches_by_thread = {}
fused_solve.launches_by_plan = {}


def _count_launch(plan):
    fused_solve.launches += 1
    by_thread = fused_solve.launches_by_thread
    me = threading.get_ident()
    by_thread[me] = by_thread.get(me, 0) + 1
    by_plan = fused_solve.launches_by_plan
    by_plan[plan.label] = by_plan.get(plan.label, 0) + 1


def build_jt(cd_lin, cd_ang, frame, rpos, w, sign_l, ld_idx):
    """J^T (B, nv, 3K + L) from the contact-Jacobian parts.

    Row r of contact c: J[rK+c, :] = frame[c,r,:] . (cd_lin[n] +
    cd_ang[n] x rpos[c]) * w[c,n]; with a.(b x c) = b.(c x a) the
    angular term contracts through G[c,r,:] = rpos[c] x frame[c,r,:].
    Limit rows are sign * e_dof."""
    B, nv, _ = cd_lin.shape
    K = frame.shape[1]
    L = len(ld_idx)
    G = torch.linalg.cross(rpos[:, :, None, :].expand_as(frame), frame,
                           dim=-1)                            # (B, K, 3, 3)
    JT_c = (torch.einsum("bcrd,bnd,bcn->bnrc", frame, cd_lin, w)
            + torch.einsum("bcri,bni,bcn->bnrc", G, cd_ang, w))
    JT_c = JT_c.reshape(B, nv, 3 * K)
    if not L:
        return JT_c.contiguous()
    JT_l = cd_lin.new_zeros(B, nv, L)
    JT_l[:, np.asarray(ld_idx), np.arange(L)] = sign_l
    return torch.cat([JT_c, JT_l], 2)


_ld_cache = {}


def _ld_tensor(ld_idx: tuple, device) -> torch.Tensor:
    """int32 tensor of the limited dofs on ``device``, made once."""
    key = (tuple(ld_idx), str(device))
    t = _ld_cache.get(key)
    if t is None:
        t = torch.tensor(key[0], dtype=torch.int32, device=device)
        _ld_cache[key] = t
    return t


def _check_parts(M, cd_lin, cd_ang, frame, rpos, w, sign_l, K, L):
    B, nv, _ = cd_lin.shape
    dev = cd_lin.device
    for name, x, shape in (("M", M, (B, nv, nv)),
                           ("cd_lin", cd_lin, (B, nv, 3)),
                           ("cd_ang", cd_ang, (B, nv, 3)),
                           ("frame", frame, (B, K, 3, 3)),
                           ("rpos", rpos, (B, K, 3)), ("w", w, (B, K, nv)),
                           ("sign_l", sign_l, (B, L))):
        _check(name, x, shape, dev)
    return B, nv, dev


def fused_solve_parts(M, cd_lin, cd_ang, frame, rpos, w, sign_l, qf, aref,
                      imp, active, mu, lam0, *, K: int, L: int,
                      ld_idx: tuple, iterations: int,
                      pyramidal: bool = False):
    """Fused solve fed by contact-Jacobian parts (the main-path entry,
    ``physics/solver.py``). On the card the kernel builds J^T's rows
    from the parts in its load phase; on the CPU this is ``build_jt`` +
    ``fused_solve_plain``."""
    if len(ld_idx) != L:
        raise ValueError(f"ld_idx has {len(ld_idx)} dofs, expected L={L}")
    B, nv, dev = _check_parts(M, cd_lin, cd_ang, frame, rpos, w, sign_l,
                              K, L)
    n = 3 * K + L
    _check_vectors(B, nv, n, K, dev, qf, aref, imp, active, mu, lam0)
    if dev.type == "cpu":
        JT = build_jt(cd_lin, cd_ang, frame, rpos, w, sign_l, ld_idx)
        return fused_solve_plain(M, JT, qf, aref, imp, active, mu, lam0,
                                 K=K, L=L, iterations=iterations,
                                 pyramidal=pyramidal)
    if dev.type != "cuda":
        raise ValueError(f"fused_solve_parts: unsupported device {dev}")
    plan = launch_plan(nv, n, K)
    if not B:
        return (M.new_empty(0, nv), M.new_empty(0, nv), M.new_empty(0, n))
    parts = [x.contiguous() for x in (cd_lin, cd_ang, frame, rpos, w,
                                      sign_l)] + [_ld_tensor(ld_idx, dev)]
    vectors = [x.contiguous() for x in (qf, aref, imp, active, mu, lam0)]
    with torch.cuda.device(dev):
        out = _launch(_load(), plan, B, nv, K, L, iterations, pyramidal,
                      M.contiguous(), None, parts, vectors)
    _count_launch(plan)
    return out


PHASES = ("load + J build", "Cholesky", "W and y", "diagA/R/b",
          "power iterations", "sweeps", "outputs")


def phase_cycles(M, cd_lin, cd_ang, frame, rpos, w, sign_l, qf, aref, imp,
                 active, mu, lam0, *, K: int, L: int, ld_idx: tuple,
                 iterations: int, pyramidal: bool = False):
    """Run the -DFUSED_SOLVE_CLOCKS build of the parts entry on CUDA
    tensors and return its clock64() stamps, (B, 8) int64: thread 0 of
    each env at the start and after each of ``PHASES``. Not counted in
    ``fused_solve.launches``: it measures, it is not the main path."""
    B, nv, dev = _check_parts(M, cd_lin, cd_ang, frame, rpos, w, sign_l,
                              K, L)
    if dev.type != "cuda":
        raise ValueError("phase_cycles runs on a CUDA device only")
    plan = launch_plan(nv, 3 * K + L, K)
    clocks = torch.zeros(B, 8, dtype=torch.int64, device=dev)
    parts = [x.contiguous() for x in (cd_lin, cd_ang, frame, rpos, w,
                                      sign_l)] + [_ld_tensor(ld_idx, dev)]
    vectors = [x.contiguous() for x in (qf, aref, imp, active, mu, lam0)]
    with torch.cuda.device(dev):
        _launch(_load(clocks=True), plan, B, nv, K, L, iterations,
                pyramidal, M.contiguous(), None, parts, vectors, clocks)
    return clocks


# H100 SXM data-sheet peaks: HBM3 bandwidth and fp32 outside the tensor
# cores (the kernel's arithmetic type)
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12


def bound_ms(B: int, nv: int, K: int, L: int, iterations: int,
             entry: str = "explicit"):
    """(bound_ms, bound_by) of one batched call of ``entry`` ("explicit":
    ``fused_solve``; "parts": ``fused_solve_parts``): the larger of the
    bytes it must move (its inputs read once, outputs written once) over
    the memory rate and the fp32 operations over the peak fp32 rate.
    Operations count the algorithm's work in flops (a multiply-add is
    2): Cholesky nv^3/3, W = L^-1 J^T nv^2 n, the two triangular vector
    solves and the L t product 3 nv^2, diagA and b 4 nv n, and per
    matvec 4 nv n + 2 n (W v, W^T u, + R v) for the 13 power matvecs and
    the sweeps, plus W lam 2 nv n. The parts entry adds the J build: per
    contact row and dof 3 + 3 multiply-adds (frame . cd_lin, G . cd_ang),
    and per contact the cross products G = rpos x frame (3 x 9 flops)."""
    n = 3 * K + L
    vec_floats = nv + 4 * n + K                         # qf, aref ..., mu
    out_floats = 2 * nv + n
    if entry == "explicit":
        in_floats = nv * nv + nv * n + vec_floats
        extra_bytes = 0
        j_ops = 0
    elif entry == "parts":
        # M, cd_lin, cd_ang, frame, rpos, w, sign_l; ld_idx once (int32)
        in_floats = (nv * nv + 6 * nv + 12 * K + K * nv + L + vec_floats)
        extra_bytes = 4 * L
        j_ops = 3 * K * nv * 2 * 6 + 27 * K
    else:
        raise ValueError(f"entry must be 'explicit' or 'parts': {entry}")
    byts = 4 * B * (in_floats + out_floats) + extra_bytes
    mv = 4 * nv * n + 2 * n
    ops = B * (nv ** 3 / 3 + nv * nv * n + 3 * nv * nv + 4 * nv * n
               + (POWER_ITERS + 1 + iterations) * mv + 2 * nv * n + j_ops)
    t_bytes = byts / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
