"""Textbook flop counts of the mass matrix (CRBA) and the bias forces
(RNE) of a kinematic tree, in spatial (6-vector) algebra.

A 6x6 matrix times a 6-vector is 72 flops, a 6x6 product 432, a spatial
cross product about 36, a projection onto a dof S^T f 12.

- RNE, per body: velocity v = X v_p + S qd (72 + 12), acceleration
  a = X a_p + v x S qd (72 + 12 + 36), force f = I a + v x* I v
  (72 + 72 + 36), and the backward pass f_p += X^T f (72) with its
  projection (12): 468 flops a body.
- CRBA: the composite inertias I_p += X^T I X (2 x 432 a body), then for
  each dof F = I S and M_ii = S^T F (84), and for each of its ancestor
  dofs F = X^T F and M_ij = S_j^T F (84 a pair).

The port computes these in MuJoCo's com-based form, which does more;
these counts are a lower bound of the work.
"""


def rne_flops(nbody: int) -> int:
    return 468 * nbody


def crba_flops(nbody: int, nv: int, ancestor_pairs: int) -> int:
    return 864 * nbody + 84 * nv + 84 * ancestor_pairs


def env_step_flops(cfg: dict, k_active_sum: float, l_active_sum: float,
                   n_envs: int, iterations: int) -> float:
    """Counted flops of ``n_envs`` Euler env steps of a configuration
    (``cfg``: its file's sizes), the solve counted at the given sums of
    active contacts and limit rows over those envs. FK, collision, the
    observation, the reward and resets are not counted."""
    from counts import solve

    nv = cfg["nv"]
    per_env = (rne_flops(cfg["nbody"])
               + crba_flops(cfg["nbody"], nv, cfg["dof_ancestor_pairs"]))
    # ops_per_env is linear in the active counts past its constant terms
    fixed = solve.ops_per_env(nv, 0, 0, iterations)
    var = (solve.ops_per_env(nv, k_active_sum, l_active_sum, iterations)
           - fixed)
    return n_envs * (per_env + fixed) + var
