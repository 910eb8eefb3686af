"""Port parity: the fused mass-matrix + constraint solve.

``fused_solve_plain`` (the port's CPU path and the reference its CUDA
kernel is held to) against the JAX package's Pallas kernel in interpret
mode (``fused_solve_single(..., interpret=True)``) and against its XLA
fallback (``physics/solver.py:_pgs_iterate`` over an explicit inverse),
at humanoid3d (nv 34, K 16, L 28) and G1 (nv 43, K 24, L 37) sizes, with
both friction cones and a nonzero warm start. Tolerance: max|d|/scale
< 2e-4, as in tests/test_fused_solve.py. The CUDA kernel itself is held
to the plain version on the card by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.ops.fused_solve import fused_solve_single
from deepmimic_mujoco_tpu.physics import linalg
from deepmimic_mujoco_tpu.physics.solver import _pgs_iterate

from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs

TOL = 2e-4
H3D, G1 = (34, 16, 28), (43, 24, 37)


def _mk(seed, B, nv, K, L):
    """Random SPD systems (tests/test_fused_solve.py:_mk, batched) with a
    nonzero warm start: M, J (B, n, nv), qf, aref, imp, active, mu,
    lam0."""
    n = 3 * K + L
    r = np.random.RandomState(seed)
    G = r.randn(B, nv, nv)
    M = G @ G.transpose(0, 2, 1) + nv * np.eye(nv)
    J = r.randn(B, n, nv) * (r.rand(B, n, 1) < 0.8)
    qf = r.randn(B, nv) * 10
    aref = r.randn(B, n)
    imp = np.clip(r.rand(B, n), 0.05, 0.95)
    act_c = r.rand(B, K) < 0.5
    active = np.concatenate([act_c, act_c, act_c, r.rand(B, L) < 0.3], 1)
    mu = np.full((B, K), 1.0)
    lam0 = r.randn(B, n)
    return [np.asarray(x, np.float32)
            for x in (M, J, qf, aref, imp, active, mu, lam0)]


def _plain(arrs, K, L, its, pyramidal):
    M, J, qf, aref, imp, active, mu, lam0 = (torch.tensor(a) for a in arrs)
    return fs.fused_solve(M, J.transpose(1, 2).contiguous(), qf, aref, imp,
                          active, mu, lam0, K=K, L=L, iterations=its,
                          pyramidal=pyramidal)


def _fallback(M, J, qf, aref, imp, active, mu, lam0, K, L, its, pyramidal):
    Minv = linalg.spd_inverse(M)
    qacc_s = Minv @ qf
    MinvJT = Minv @ J.T
    A = J @ MinvJT
    b = J @ qacc_s - aref
    diagA = jnp.clip(jnp.diagonal(A), 1e-8, None)
    R = (1.0 - imp) / imp * diagA
    invd = 1.0 / jnp.clip(diagA + R, 1e-8, None)
    lam = _pgs_iterate(A + jnp.diag(R), b, invd, mu, active, K=K, L=L,
                       iterations=its, relaxation=0.15, lam0=lam0,
                       pyramidal=pyramidal)
    return qacc_s + MinvJT @ lam, J.T @ lam, lam


def _assert_close(want, got):
    for name, a, b in zip(("qacc", "qfrc", "lam"), want, got):
        a, b = np.asarray(a, np.float64), b.numpy().astype(np.float64)
        err = np.abs(a - b).max() / max(np.abs(a).max(), 1.0)
        assert err < TOL, (name, err)


@pytest.mark.parametrize("dims", [H3D, G1], ids=["h3d", "g1"])
@pytest.mark.parametrize("pyramidal", [False, True],
                         ids=["elliptic", "pyramidal"])
def test_plain_matches_pgs_fallback(dims, pyramidal):
    nv, K, L = dims
    arrs = _mk(nv + int(pyramidal), 4, nv, K, L)
    want = jax.jit(jax.vmap(lambda *a: _fallback(
        *a, K, L, 50, pyramidal)))(*map(jnp.asarray, arrs))
    _assert_close(want, _plain(arrs, K, L, 50, pyramidal))


# interpret mode costs ~10 s a call on the CPU whatever the count, so
# two calls cover both sizes and both cones; G1 at a reduced count
@pytest.mark.parametrize("dims,its,pyramidal",
                         [(H3D, 50, False), (G1, 10, True)],
                         ids=["h3d-elliptic", "g1-pyramidal"])
def test_plain_matches_pallas_interpret(dims, its, pyramidal):
    nv, K, L = dims
    arrs = _mk(7 + nv, 2, nv, K, L)
    want = jax.vmap(lambda M, J, qf, aref, imp, act, mu, lam0:
                    fused_solve_single(M, J, qf, aref, imp, act, mu, lam0,
                                       K=K, L=L, iterations=its,
                                       pyramidal=pyramidal,
                                       interpret=True))(
        *map(jnp.asarray, arrs))
    _assert_close(want, _plain(arrs, K, L, its, pyramidal))


def test_build_jt_matches_explicit_j():
    """J^T from the contact-Jacobian parts equals the J the JAX package
    assembles: rows [frame_r . (cd_lin + cd_ang x r) * w | sign e_dof]."""
    nv, K, L = H3D
    B = 2
    r = np.random.RandomState(11)
    ld_idx = tuple(int(i) for i in np.sort(r.choice(nv, L, replace=False)))
    cd_lin = r.randn(B, nv, 3).astype(np.float32)
    cd_ang = r.randn(B, nv, 3).astype(np.float32)
    frame = r.randn(B, K, 3, 3).astype(np.float32)
    rpos = r.randn(B, K, 3).astype(np.float32)
    w = (r.rand(B, K, nv) < 0.5).astype(np.float32)
    sign = np.where(r.rand(B, L) < 0.5, 1.0, -1.0).astype(np.float32)
    got = fs.build_jt(*(torch.tensor(a) for a in
                        (cd_lin, cd_ang, frame, rpos, w, sign)), ld_idx)
    Jp = (cd_lin[:, None] + np.cross(cd_ang[:, None], rpos[:, :, None, :])
          ) * w[..., None]                                  # (B, K, nv, 3)
    Jc = np.einsum("bkrd,bknd->bkrn", frame, Jp)
    E = np.zeros((L, nv), np.float32)
    E[np.arange(L), list(ld_idx)] = 1.0
    J = np.concatenate([Jc[:, :, 0], Jc[:, :, 1], Jc[:, :, 2],
                        sign[..., None] * E], axis=1)      # (B, n, nv)
    np.testing.assert_allclose(got.numpy(), J.transpose(0, 2, 1),
                               atol=1e-5)
    # and the parts entry solves the same system as the explicit-J entry
    M, _, qf, aref, imp, active, mu, lam0 = (
        torch.tensor(a) for a in _mk(5, B, nv, K, L))
    want = fs.fused_solve(M, torch.tensor(J.transpose(0, 2, 1).copy()), qf,
                          aref, imp, active, mu, lam0, K=K, L=L,
                          iterations=20)
    got = fs.fused_solve_parts(
        M, *(torch.tensor(a) for a in (cd_lin, cd_ang, frame, rpos, w,
                                       sign)),
        qf, aref, imp, active, mu, lam0, K=K, L=L, ld_idx=ld_idx,
        iterations=20)
    _assert_close([x.numpy() for x in want], got)


def test_wrapper_rejects_bad_input():
    nv, K, L = H3D
    args = [torch.tensor(a) for a in _mk(1, 2, nv, K, L)]
    args[1] = args[1].transpose(1, 2).contiguous()
    with pytest.raises(ValueError):
        fs.fused_solve(*args, K=K + 1, L=L, iterations=5)
    with pytest.raises(TypeError):
        fs.fused_solve(args[0].double(), *args[1:], K=K, L=L, iterations=5)
    with pytest.raises(ValueError):
        fs.fused_solve(*args[:7], args[7][:, :-1], K=K, L=L, iterations=5)


def test_bound_counts_work():
    ms, by = fs.bound_ms(2048, *H3D, iterations=50)
    assert by == "operations" and 0.01 < ms < 0.05
