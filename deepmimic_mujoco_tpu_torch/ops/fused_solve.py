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

``fused_solve`` takes the plain version for CPU tensors and launches the
kernel (``csrc/fused_solve.cu``) for CUDA tensors; there is no fallback
between them. The kernel is built with nvcc into
``build/torch_kernels/libfused_solve.so`` at first use and bound with
ctypes.

What bounds it on the H100: at humanoid3d size (nv 34, n 76) an env
moves ~17 KB and does ~0.78 MFLOP, so the work is compute-bound by the
fp32 rate: for 2048 envs ``bound_ms`` gives 23.9 us of arithmetic at the
data sheet's 67 TFLOP/s against 10.4 us of memory traffic at 3.35 TB/s
(counted from the shapes, not measured). The design keeps every
intermediate of an env in one thread block's shared memory — M, W and
the vectors, a ~22 KB working set at humanoid3d and ~37 KB at G1 in
35,476 bytes of static shared memory sized for nv <= 48, n <= 112 — so
nothing but the inputs and outputs touches device memory, and spreads
envs over SMs one block each.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

POWER_ITERS = 12  # matches physics/solver.py:_pgs_iterate
# static shared-memory capacity of the kernel (csrc/fused_solve.cu)
NV_MAX = 48
N_MAX = 112

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "fused_solve.cu")
BUILD_DIR = os.path.join(_REPO, "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the fused-solve kernel is built "
                       "from csrc/fused_solve.cu at first use")


def build(force: bool = False) -> str:
    """Compile csrc/fused_solve.cu into the shared library (when missing,
    older than the source, or ``force``) and return its path. Raises
    with nvcc's output when the build fails; ptxas's resource report
    (registers, shared memory, spills) is kept in ``build.ptxas``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, "libfused_solve.so")
    if (not force and os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(SOURCE)):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    build.ptxas = (proc.stdout + proc.stderr).strip()
    os.replace(tmp, out)
    return out


build.ptxas = ""


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.fused_solve_launch
            fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


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

def _check(name, x, shape, device):
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")


def fused_solve(M, JT, qf, aref, imp, active, mu, lam0, *, K: int, L: int,
                iterations: int, pyramidal: bool = False):
    """Batched fused solve. CPU tensors take ``fused_solve_plain``; CUDA
    tensors launch the kernel (or raise). ``fused_solve.launches``
    counts kernel launches."""
    B, nv, n = JT.shape
    if n != 3 * K + L:
        raise ValueError(f"n={n} rows, expected 3*K+L={3 * K + L}")
    dev = JT.device
    for name, x, shape in (("M", M, (B, nv, nv)), ("JT", JT, (B, nv, n)),
                           ("qf", qf, (B, nv)), ("aref", aref, (B, n)),
                           ("imp", imp, (B, n)), ("active", active, (B, n)),
                           ("mu", mu, (B, K)), ("lam0", lam0, (B, n))):
        _check(name, x, shape, dev)
    if dev.type == "cpu":
        return fused_solve_plain(M, JT, qf, aref, imp, active, mu, lam0,
                                 K=K, L=L, iterations=iterations,
                                 pyramidal=pyramidal)
    if dev.type != "cuda":
        raise ValueError(f"fused_solve: unsupported device {dev}")
    if nv > NV_MAX or n > N_MAX:
        raise ValueError(f"fused_solve kernel holds nv <= {NV_MAX} and "
                         f"n <= {N_MAX}; got nv={nv}, n={n}")
    ins = [x.contiguous() for x in (M, JT, qf, aref, imp, active, mu, lam0)]
    qacc = torch.empty(B, nv, dtype=torch.float32, device=dev)
    qfrc = torch.empty(B, nv, dtype=torch.float32, device=dev)
    lam = torch.empty(B, n, dtype=torch.float32, device=dev)
    if B:
        lib = _load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.fused_solve_launch(
                *[x.data_ptr() for x in ins], qacc.data_ptr(),
                qfrc.data_ptr(), lam.data_ptr(), B, nv, n, K, L,
                int(iterations), int(bool(pyramidal)), stream)
        if err != 0:
            raise RuntimeError(f"fused_solve kernel launch failed: "
                               f"cudaError {err}")
        fused_solve.launches += 1
    return qacc, qfrc, lam


fused_solve.launches = 0


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


def fused_solve_parts(M, cd_lin, cd_ang, frame, rpos, w, sign_l, qf, aref,
                      imp, active, mu, lam0, *, K: int, L: int,
                      ld_idx: tuple, iterations: int,
                      pyramidal: bool = False):
    """Fused solve fed by contact-Jacobian parts (the main-path entry,
    ``physics/solver.py``). J^T is built in torch, as the JAX package
    builds it outside its kernel."""
    JT = build_jt(cd_lin, cd_ang, frame, rpos, w, sign_l, ld_idx)
    return fused_solve(M.contiguous(), JT, qf, aref, imp, active, mu, lam0,
                       K=K, L=L, iterations=iterations, pyramidal=pyramidal)


# H100 SXM data-sheet peaks: HBM3 bandwidth and fp32 outside the tensor
# cores (the kernel's arithmetic type)
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12


def bound_ms(B: int, nv: int, K: int, L: int, iterations: int):
    """(bound_ms, bound_by) of one batched call: the larger of the bytes
    it must move (inputs read once, outputs written once) over the
    memory rate and the fp32 operations over the peak fp32 rate.
    Operations count the algorithm's work:
    Cholesky nv^3/3, W = L^-1 J^T nv^2 n, the two triangular vector
    solves and the L t product 3 nv^2, diagA and b 4 nv n, and per
    matvec 4 nv n + 2 n (W v, W^T u, + R v) for the 13 power matvecs and
    the sweeps, plus W lam 2 nv n."""
    n = 3 * K + L
    byts = 4 * B * (nv * nv + nv * n + nv + 4 * n + K   # inputs
                    + 2 * nv + n)                       # outputs
    mv = 4 * nv * n + 2 * n
    ops = B * (nv ** 3 / 3 + nv * nv * n + 3 * nv * nv + 4 * nv * n
               + (POWER_ITERS + 1 + iterations) * mv + 2 * nv * n)
    t_bytes = byts / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
