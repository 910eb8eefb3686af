"""The fused mass-matrix and constraint solve, plain torch.

Frozen copy of the port's plain version of the solve
(``ops/fused_solve.py``: ``_project``, ``fused_solve_plain``,
``build_jt``): the function the CUDA kernel computes, batched, in
whatever dtype its inputs have. No kernel, no launch plan.
"""
import numpy as np
import torch

POWER_ITERS = 12  # matches physics/solver.py:_pgs_iterate


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
    """The solve fed by contact-Jacobian parts: ``build_jt`` then
    ``fused_solve_plain``."""
    JT = build_jt(cd_lin, cd_ang, frame, rpos, w, sign_l, ld_idx)
    return fused_solve_plain(M, JT, qf, aref, imp, active, mu, lam0, K=K,
                             L=L, iterations=iterations, pyramidal=pyramidal)
