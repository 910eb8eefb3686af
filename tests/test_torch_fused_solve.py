"""Port parity: the fused mass-matrix + constraint solve.

``fused_solve_plain`` (the port's CPU path and the reference its CUDA
kernel is held to) against the JAX package's Pallas kernel in interpret
mode (``fused_solve_single(..., interpret=True)``) and against its XLA
fallback (``physics/solver.py:_pgs_iterate`` over an explicit inverse),
at humanoid3d (nv 34, K 16, L 28) and G1 (nv 43, K 24, L 37) sizes, with
both friction cones and a nonzero warm start, and at the sizes of the
kernel's shared-memory plan (G1 at 48 and 64 contact slots, humanoid3d
at 128); the parts entry (``fused_solve_parts``, the main path's)
against the JAX package's parts entry in interpret mode. Tolerance:
max|d|/scale < 2e-4, as in tests/test_fused_solve.py. Also the kernel's
launch plans (which thread holds which entry of W, which plan a size
takes, the shared-memory limit) and the bound's operation and byte
counts. The CUDA kernel itself is held to the plain version on the card
by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.ops.fused_solve import (fused_solve_parts_single,
                                                  fused_solve_single)
from deepmimic_mujoco_tpu.physics import linalg
from deepmimic_mujoco_tpu.physics.solver import _pgs_iterate

from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs

TOL = 2e-4
H3D, G1 = (34, 16, 28), (43, 24, 37)
# sizes of the shared-memory plan: more contact slots than a register
# plan holds
G1_K48, G1_K64, H3D_K128 = (43, 48, 37), (43, 64, 37), (34, 128, 28)


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


def _mk_parts(seed, B, nv, K, L):
    """Contact-Jacobian parts like the engine's: orthonormal contact
    frames, contact points near the root, signed 0/1 dof masks, and L
    distinct limited dofs. Returns ([cd_lin, cd_ang, frame, rpos, w,
    sign_l], ld_idx)."""
    r = np.random.RandomState(seed)
    frame, _ = np.linalg.qr(r.randn(B, K, 3, 3))
    parts = [r.randn(B, nv, 3), r.randn(B, nv, 3), frame,
             r.randn(B, K, 3) * 0.3, r.choice([-1.0, 0.0, 1.0], (B, K, nv)),
             np.where(r.rand(B, L) < 0.5, 1.0, -1.0)]
    ld_idx = tuple(int(i) for i in np.sort(r.choice(nv, L, replace=False)))
    return [np.asarray(x, np.float32) for x in parts], ld_idx


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


@pytest.mark.parametrize("dims", [H3D, G1, G1_K64, H3D_K128],
                         ids=["h3d", "g1", "g1-k64", "h3d-k128"])
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


# the parts entry: the same two interpret-mode calls as above, and G1 at
# 48 slots (a shared-memory plan size; the JAX kernel's manual-DMA
# branch) at the same reduced count
@pytest.mark.parametrize("dims,its,pyramidal",
                         [(H3D, 50, False), (G1, 10, True),
                          (G1_K48, 10, False)],
                         ids=["h3d-elliptic", "g1-pyramidal",
                              "g1-k48-elliptic"])
def test_parts_matches_pallas_interpret(dims, its, pyramidal):
    nv, K, L = dims
    M, _, qf, aref, imp, active, mu, lam0 = _mk(13 + nv, 2, nv, K, L)
    parts, ld_idx = _mk_parts(17 + nv, 2, nv, K, L)
    vectors = [qf, aref, imp, active, mu, lam0]
    want = jax.vmap(lambda M, cl, ca, fr, rp, w, sg, qf, aref, imp, act, mu,
                    lam0: fused_solve_parts_single(
                        M, cl, ca, fr, rp, w, sg, qf, aref, imp, act, mu,
                        lam0, K=K, L=L, ld_idx=ld_idx, iterations=its,
                        pyramidal=pyramidal, interpret=True))(
        *map(jnp.asarray, [M, *parts, *vectors]))
    got = fs.fused_solve_parts(
        *(torch.tensor(a) for a in [M, *parts, *vectors]), K=K, L=L,
        ld_idx=ld_idx, iterations=its, pyramidal=pyramidal)
    _assert_close(want, got)


@pytest.mark.parametrize("nv,K,L", [(34, 16, 28), (43, 24, 37),
                                    (48, 24, 40)],
                         ids=["34x76", "43x109", "48x112"])
def test_launch_plan_covers_w(nv, K, L):
    """Every (row, col) of W lies in exactly one thread of its env, and
    the plan fits the card: shared memory, threads per block, and the W
    values a thread holds in registers."""
    n = 3 * K + L
    plan = fs.launch_plan(nv, n, K)
    cells = [(row, col) for _, row, col, _ in fs.plan_cells(plan, nv, K, L)]
    assert len(cells) == nv * n
    assert set(cells) == {(i, c) for i in range(nv) for c in range(n)}
    owners = {}
    for tid, row, col, in_regs in fs.plan_cells(plan, nv, K, L):
        assert 0 <= tid < plan.threads_per_env
        assert in_regs
        owners.setdefault(tid, set()).add(col)
    # a contact's normal and both tangent rows lie in one thread
    for cols in owners.values():
        for c in cols:
            if c < K:
                assert {c + K, c + 2 * K} <= cols
    assert plan.smem_bytes <= fs.SMEM_PER_BLOCK
    assert plan.threads_per_block <= fs.THREADS_PER_BLOCK
    assert plan.threads_per_block == (plan.threads_per_env
                                      * plan.envs_per_block)
    assert plan.threads_per_env % 32 == 0
    assert plan.w_regs == plan.rpt * plan.cols_per_thread
    assert plan.w_regs <= fs.W_REGS_BUDGET
    assert plan[:5] in fs.PLANS


@pytest.mark.parametrize("nv,K,L", [(43, 26, 37), (34, 29, 28),
                                    (43, 128, 37), (34, 128, 28),
                                    (60, 10, 50), (43, 37, 37),
                                    (43, 374, 37), (34, 121, 28)],
                         ids=["43x115", "34x115", "43x421", "34x412",
                              "60x80", "43x148", "43x1159", "34x391"])
def test_shared_plan_covers_w(nv, K, L):
    """In the shared-memory plan every entry of W has exactly one owner,
    in its registers or in its shared-memory slots; a contact's triple
    lies in one thread and in one of the two; a thread's register part
    is its rpt x (3 kc + lc) tile; units (contacts and limit rows) per
    column group differ by at most one; and the env fits one block."""
    n = 3 * K + L
    plan = fs.launch_plan(nv, n, K)
    assert plan.shared and plan[:5] in fs.SHARED_PLANS
    cells = list(fs.plan_cells(plan, nv, K, L))
    assert len(cells) == nv * n
    assert {(row, col) for _, row, col, _ in cells} == {
        (i, c) for i in range(nv) for c in range(n)}
    owners, regs, units = {}, {}, {}
    for tid, row, col, in_regs in cells:
        assert 0 <= tid < plan.threads_per_env
        owners.setdefault(tid, {})[col] = in_regs
        regs[tid] = regs.get(tid, 0) + in_regs
        units.setdefault(tid // plan.tr, set()).add(
            col % K if col < 3 * K else col)
    for cols in owners.values():
        for c, in_regs in cols.items():
            if c < K:
                assert cols.get(c + K) is in_regs
                assert cols.get(c + 2 * K) is in_regs
    assert max(regs.values()) <= plan.w_regs == plan.rpt * (3 * plan.kc
                                                            + plan.lc)
    assert max(len(c) for c in owners.values()) <= plan.cols_per_thread
    count = [len(units.get(cg, ())) for cg in range(plan.tc)]
    assert max(count) - min(count) <= 1
    assert nv <= plan.tr * plan.rpt
    assert plan.threads_per_env == plan.tr * plan.tc == 128
    assert plan.smem_bytes == fs.shared_smem_bytes(nv, n, K, plan)
    assert plan.smem_bytes <= fs.SMEM_PER_BLOCK


def test_launch_plan_picks_shared_beyond_registers():
    """The main paths keep their register plans; from G1 K 26 and
    humanoid3d K 29 (past 112 constraint rows) up to K 128 the
    shared-memory plan holds the env, within one block's shared memory
    (G1 at 128 slots: 66,792 B, worked by hand)."""
    assert fs.launch_plan(34, 76, 16)[:5] == (4, 8, 9, 2, 4)
    assert fs.launch_plan(43, 109, 24)[:5] == (4, 16, 11, 2, 3)
    for (nv, L), k_reg in (((43, 37), 25), ((34, 28), 28)):
        assert not fs.launch_plan(nv, 3 * k_reg + L, k_reg).shared
        for K in range(k_reg + 1, 129):
            plan = fs.launch_plan(nv, 3 * K + L, K)
            assert plan.shared, (nv, K)
            assert plan.smem_bytes <= fs.SMEM_PER_BLOCK
    # (4, 32, 11, 2, 0): 2 shared contact and 2 shared limit slots, 8
    # shared columns. 4 (column constants 4 * 32 * (6 + 8), W 8 * 11 * 128,
    # the vector 8 * 128, mu (2 + 2) * 32, L 43 * 43, 3 * 43, partials
    # 2 * 4 * 4 * 16)
    n = 421
    assert fs.launch_plan(43, n, 128)[:5] == (4, 32, 11, 2, 0)
    assert fs.launch_plan(43, n, 128).smem_bytes == 4 * (
        1792 + 11264 + 1024 + 128 + 1849 + 129 + 512) == 66792
    assert fs.launch_plan(34, 412, 128).smem_bytes <= fs.SMEM_PER_BLOCK


@pytest.mark.parametrize("nv,K,L,want", [
    (43, 26, 37, (4, 32, 11, 1, 2)), (43, 32, 37, (4, 32, 11, 1, 2)),
    (43, 33, 37, (4, 32, 11, 2, 0)), (43, 384, 37, (4, 32, 11, 2, 0)),
    (34, 29, 28, (4, 32, 9, 2, 1)), (34, 121, 28, (4, 32, 9, 2, 1)),
    (60, 10, 50, (4, 32, 16, 1, 0))],
    ids=["g1-k26", "g1-k32", "g1-k33", "g1-k384", "h3d-k29", "h3d-k121",
         "nv60"])
def test_launch_plan_picks_shared_instance(nv, K, L, want):
    """Of the shared-memory instances with the fewest rows that hold nv,
    the plan takes the one with the fewest columns in shared memory: the
    G1 holds all of W in registers up to 32 contact slots (one contact
    and two limit rows a thread), then two contacts a thread."""
    plan = fs.launch_plan(nv, 3 * K + L, K)
    assert plan[:5] == want
    shared_cols = plan.cols_per_thread - (3 * plan.kc + plan.lc)
    assert shared_cols == min(
        fs._shared_cols(K, L, p) for p in fs.SHARED_PLANS
        if p[0] * p[2] == plan.tr * plan.rpt)
    if K <= 32 and nv == 43:
        assert shared_cols == 0


def test_launch_plan_refuses_what_no_plan_holds():
    """Past the shared-memory limit (G1 384 slots, humanoid3d 480) no
    plan holds the env, nor any system whose L alone outgrows a block,
    nor one of more dofs than the 64 rows of any plan."""
    for (nv, L), k_max in (((43, 37), 384), ((34, 28), 480)):
        fs.launch_plan(nv, 3 * k_max + L, k_max)
        with pytest.raises(ValueError, match="shared memory"):
            fs.launch_plan(nv, 3 * (k_max + 1) + L, k_max + 1)
    with pytest.raises(ValueError):
        fs.launch_plan(250, 10, 0)
    with pytest.raises(ValueError, match="rows of any plan"):
        fs.launch_plan(65, 10, 0)
    with pytest.raises(ValueError):
        fs.launch_plan(34, 10, 4)          # L < 0


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


def test_parts_wrapper_rejects_bad_input():
    nv, K, L = H3D
    M, _, *vectors = (torch.tensor(a) for a in _mk(2, 2, nv, K, L))
    parts, ld_idx = _mk_parts(3, 2, nv, K, L)
    parts = [torch.tensor(a) for a in parts]
    kw = dict(K=K, L=L, iterations=5)
    with pytest.raises(ValueError, match="ld_idx"):
        fs.fused_solve_parts(M, *parts, *vectors, ld_idx=ld_idx[:-1], **kw)
    with pytest.raises(ValueError, match="frame"):
        fs.fused_solve_parts(M, parts[0], parts[1], parts[2][:, :-1],
                             *parts[3:], *vectors, ld_idx=ld_idx, **kw)
    with pytest.raises(TypeError):
        fs.fused_solve_parts(M, parts[0].double(), *parts[1:], *vectors,
                             ld_idx=ld_idx, **kw)


def test_bound_counts_work():
    """bound_ms of both entries at humanoid3d, B 2048, 50 sweeps, against
    counts worked by hand (nv 34, K 16, L 28, n 76; flops, a
    multiply-add is 2; fp32 67 TFLOP/s, HBM 3.35 TB/s)."""
    B, nv, K, L, n = 2048, 34, 16, 28, 76
    # Cholesky 34^3/3, W 34^2 * 76, triangular vector solves 3 * 34^2,
    # diagA and b 4 * 34 * 76, 63 matvecs of 4 * 34 * 76 + 2 * 76, W lam
    # 2 * 34 * 76
    solve = 39304 / 3 + 87856 + 3468 + 10336 + 63 * 10488 + 5168
    assert solve == pytest.approx(780673.3333333334)
    # J build: 48 contact rows x 34 dofs x 6 multiply-adds, and three
    # cross products (27 flops) per contact
    jbuild = 48 * 34 * 12 + 16 * 27
    assert jbuild == 20016
    # explicit: M 1156, J^T 2584, qf 34, aref/imp/active/lam0 304, mu 16
    # in; qacc, qfrc 68 and lam 76 out
    explicit_bytes = 4 * B * (1156 + 2584 + 34 + 304 + 16 + 68 + 76)
    # parts: M 1156, cd_lin + cd_ang 204, frame + rpos 192, w 544,
    # sign_l 28 and the same vectors per env; ld_idx once (28 int32)
    parts_bytes = (4 * B * (1156 + 204 + 192 + 544 + 28 + 34 + 304 + 16
                            + 68 + 76) + 4 * 28)
    for entry, ops, byts in (("explicit", solve, explicit_bytes),
                             ("parts", solve + jbuild, parts_bytes)):
        ms, by = fs.bound_ms(B, nv, K, L, iterations=50, entry=entry)
        t_ops = B * ops / 67e12 * 1e3
        t_bytes = byts / 3.35e12 * 1e3
        assert t_ops > t_bytes
        assert by == "operations"
        assert ms == pytest.approx(t_ops, rel=1e-12)
    assert fs.bound_ms(B, nv, K, L, 50, "parts")[0] == pytest.approx(
        0.0244748, rel=1e-5)
    assert fs.bound_ms(B, nv, K, L, 50)[0] == pytest.approx(
        0.0238630, rel=1e-5)
    with pytest.raises(ValueError):
        fs.bound_ms(B, nv, K, L, 50, entry="other")
