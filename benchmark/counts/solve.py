"""Operations and bytes of one fused-solve call (the contact and limit
solve of one Euler step, batched over envs).

The formula is a frozen copy of the port's ``ops/fused_solve.py:
bound_ms`` (the H100 data-sheet peaks beside it): per env, with n
constraint rows and K contact slots,

- Cholesky of M: nv^3 / 3
- W = L^-1 J^T: nv^2 n
- the two triangular vector solves and the L t product: 3 nv^2
- diagA and b: 4 nv n
- each matvec A v = W^T (W v) + R v: 4 nv n + 2 n, taken 13 times by the
  power iteration and once per sweep (``iterations``)
- the force product W lam: 2 nv n
- the J build of the parts entry: per contact, 3 rows x nv dofs x 2 x 6
  (frame . cd_lin and G . cd_ang) plus 27 for G = rpos x frame.

``ops_per_env`` counts what one env's inputs need: its active contacts
and active limit rows (``n = 3 K_active + L_active``), so empty slots are
not credited. ``all_slots_ops`` counts every slot, as ``bound_ms`` does.
Bytes are every input read once and every output written once, at the
full slot count (the kernel reads each slot's activity to skip it).
"""
POWER_ITERS = 12
H100_BYTES_PER_S = 3.35e12    # HBM3, SXM data sheet
H100_FP32_FLOPS = 67e12       # fp32 outside the tensor cores


def ops_per_env(nv: int, k_active, l_active, iterations: int):
    """Flops of one env's solve; ``k_active`` and ``l_active`` may be
    arrays (one entry per env)."""
    n = 3 * k_active + l_active
    mv = 4 * nv * n + 2 * n
    j_ops = 3 * k_active * nv * 2 * 6 + 27 * k_active
    return (nv ** 3 / 3 + nv * nv * n + 3 * nv * nv + 4 * nv * n
            + (POWER_ITERS + 1 + iterations) * mv + 2 * nv * n + j_ops)


def call_bytes(B: int, nv: int, K: int, L: int) -> float:
    """Bytes of one call of the parts entry over ``B`` envs."""
    n = 3 * K + L
    vec_floats = nv + 4 * n + K
    out_floats = 2 * nv + n
    in_floats = nv * nv + 6 * nv + 12 * K + K * nv + L + vec_floats
    return 4 * B * (in_floats + out_floats) + 4 * L


def all_slots_ops(B: int, nv: int, K: int, L: int, iterations: int):
    return B * ops_per_env(nv, K, L, iterations)


def bound_s(ops: float, byts: float) -> float:
    """The least time of a call: the larger of its operations over the
    fp32 peak and its bytes over the memory rate."""
    return max(ops / H100_FP32_FLOPS, byts / H100_BYTES_PER_S)
