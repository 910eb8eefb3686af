// Fused mass-matrix solve + constraint solve for Hopper (sm_90a).
//
// Replaces the TPU kernel deepmimic_mujoco_tpu/ops/fused_solve.py:
// _fused_kernel (a Pallas kernel that holds 128 envs in the lanes of one
// grid program). Per env, in fp32, it computes what that kernel computes:
//   1. Cholesky M = L L^T (right-looking)
//   2. W = L^-1 J^T, and y = L^-1 qf
//   3. diagA = sum_i W_i^2, R = (1-imp)/imp diagA, b = W^T y - aref
//   4. 12 power iterations on the active rows -> step = min(1.5/lmax, 1)
//   5. `iterations` projected diagonal-scaled gradient sweeps from
//      project(lam0), Ahat v = W^T (W v) + R v, elliptic cone (or the L1
//      diamond when `pyramidal`), limit rows >= 0, all masked by active
//   6. qacc = L^-T (y + W lam), qfrc = L (W lam), lam.
// The step rule, the clamps, the projection and the warm start copy
// physics/solver.py:_pgs_iterate of the JAX package exactly; only the
// order of the sums differs.
//
// Two load paths share the body: the explicit one copies J^T (B, nv, n)
// into shared memory; the parts one builds the rows of J there from the
// contact-Jacobian parts (cd_lin, cd_ang, frame, rpos, w, sign_l, ld_idx),
// so J^T never reaches device memory.
//
// What bounds it on the H100: ~0.78 MFLOP per env at humanoid3d size
// (nv 34, n 76) against ~17 KB of input and output (~10 KB from the
// parts), so the fp32 rate sets the bound (ops/fused_solve.py:bound_ms).
// Of that work, 63 matvec pairs (13 power iterations, 50 sweeps) with the
// nv x n matrix W dominate, so W stays in registers for the whole solve:
//   - the T = TR x TC threads of an env form a grid; thread (rg, cg) =
//     (tid % TR, tid / TR) owns rows rg, rg + TR, ... (RPT of them) and
//     a fixed set of CPT columns: for each of its KC contacts
//     c = cg + TC q the three rows c, K + c, 2K + c of J (normal and
//     both tangents), then LC limit rows 3K + cg + TC p. A contact's
//     triple therefore lies in one thread, and the cone projection runs
//     in registers without any exchange;
//   - W v sums over a thread's columns, then over the TC threads of a
//     row group (__shfl_xor over lane bits TR..16, and one shared-memory
//     exchange between warps when an env has more than one warp);
//     W^T u sums over a thread's rows, then over its TR row groups
//     (__shfl_xor over lane bits 1..TR/2, always inside one warp). The
//     xor butterfly leaves the same bits in every lane of a group;
//   - a sweep reads W from no memory and takes no barrier when an env is
//     one warp (one when it is more); its only shared-memory reads are
//     one broadcast float4 per column of {R, 1/diag, b, active};
//   - Cholesky runs in registers (M laid out like W), right-looking, one
//     barrier per column; W = L^-1 J^T, y = L^-1 qf and the backward
//     solve for qacc run right-looking too: for each k the owner scales
//     row k and broadcasts it with __shfl, and every thread updates its
//     rows, parallel over rows and columns. No phase runs on one thread;
//   - the loops are free of branches (masks are selects; the iterative
//     phases use branch-free square roots and quotients, see fsqrt),
//     since a branch splits the code that the scheduler interleaves;
//   - dynamic shared memory, sized from (nv, n), holds J^T while it is
//     loaded, L, the column constants and a few vectors.
// On the card the kernel is latency-bound: one env is one warp's chain of
// dependent steps (shuffle levels, the pivot, the projection), and the
// time is that chain times the waves of envs that the registers allow
// (~220 per thread at humanoid3d: 8 one-warp envs per SM).
// The thread grid (the plan) is a template constant; the wrapper
// (ops/fused_solve.py:launch_plan) picks it from FUSED_SOLVE_PLANS and
// computes the shared-memory bytes by the same sum as Smem::floats.
// Sizes that no register plan holds (up to REG_N_MAX constraint rows)
// take the shared-memory plan, fused_solve_shared_kernel below: the same
// pipeline with W in shared memory, up to what one block's shared memory
// holds (Shared::floats, mirrored by ops/fused_solve.py:
// shared_smem_bytes).
//
// Built with -DFUSED_SOLVE_CLOCKS, thread 0 of each env writes clock64()
// at the 8 phase boundaries into clocks (B, 8); the default build has no
// clock code.
#include <cuda_runtime.h>

// the register plans' range (ops/fused_solve.py:REG_NV_MAX ...); larger
// sizes take the shared-memory plan, up to what one block holds
#define REG_NV_MAX 48
#define REG_N_MAX 112
#define REG_K_MAX 37
#define SMEM_MAX 232448  // H100: most dynamic shared memory of one block
#define POWER_ITERS 12
#define FULL 0xffffffffu

#ifdef FUSED_SOLVE_CLOCKS
#define STAMP(i)                    \
  if (tid == 0 && a.clocks)         \
    a.clocks[e * 8 + (i)] = clock64();
#else
#define STAMP(i)
#endif

struct Args {
  const float *M, *JT;                                // explicit path
  const float *cd_lin, *cd_ang, *frame, *rpos, *w;   // parts path
  const float* sign_l;
  const int* ld_idx;
  const float *qf, *aref, *imp, *active, *mu, *lam0;
  float *qacc, *qfrc, *lam;
  long long* clocks;
  int nv, n, K, L, iterations, pyramidal;
};

template <int TR_, int TC_, int RPT_, int KC_, int LC_>
struct Plan {
  static constexpr int TR = TR_, TC = TC_, RPT = RPT_, KC = KC_, LC = LC_;
  static constexpr int CPT = 3 * KC + LC;
  static constexpr int T = TR * TC;
  static constexpr int NW = T / 32;
  static_assert(T % 32 == 0 && 32 % TR == 0, "plan shape");
};

// (TR, TC, RPT, KC, LC): the plans the kernel is compiled for, in the
// order launch_plan tries them (ops/fused_solve.py:PLANS).
#define FUSED_SOLVE_PLANS(X) \
  X(4, 8, 9, 2, 4)           \
  X(4, 16, 11, 2, 3)         \
  X(4, 32, 12, 2, 2)

// Shared-memory layout of one env, in floats (the wrapper's
// _register_plan computes the same sum): per column group the column
// constants {R, 1/diag, b, active} as float4s (CVS of them, an odd count,
// so the 8 column groups of a warp hit disjoint banks), J^T staged by
// the load phase (nv rows, stride n|1), L (nv rows, stride nv|1), 1/L_kk,
// y, t, two Cholesky column buffers, two buffers of per-warp row
// partials when an env spans several warps, and a line that takes the
// stores of the threads that do not own a Cholesky column.
template <class P>
struct Smem {
  static constexpr int MC = (P::TR * P::RPT + P::TC - 1) / P::TC;
  static constexpr int CS = P::TR * P::RPT > P::TC * MC ? P::TR * P::RPT
                                                         : P::TC * MC;
  static constexpr int CVS = P::CPT | 1;
  static constexpr int PART = P::NW > 1 ? 2 * P::NW * P::TR * P::RPT : 0;
  static constexpr int TRASH = P::T + P::TR * P::RPT;
  __host__ __device__ static constexpr int floats(int nv, int n) {
    return 4 * P::TC * CVS + nv * (n | 1) + nv * (nv | 1) + 3 * nv +
           2 * CS + PART + TRASH;
  }
};

template <class P>
__device__ __forceinline__ void grp_sync() {
  if (P::NW == 1)
    __syncwarp();
  else
    __syncthreads();
}

// Global column of slot j of column group cg, or -1 for a pad slot.
template <class P>
__device__ __forceinline__ int col_of(int j, int cg, int K, int L) {
  if (j < 3 * P::KC) {
    int c = cg + P::TC * (j / 3);
    return c < K ? (j % 3) * K + c : -1;
  }
  int l = cg + P::TC * (j - 3 * P::KC);
  return l < L ? 3 * K + l : -1;
}

// Sum over the TR row groups (the W^T u side): inside one warp.
template <class P>
__device__ __forceinline__ float colsum(float v) {
#pragma unroll
  for (int o = 1; o < P::TR; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Sum of RPT row partials over the TC column groups (the W v side).
template <class P>
__device__ __forceinline__ void rowsum(float (&u)[P::RPT], float* part,
                                       int& buf, int tid) {
#pragma unroll
  for (int o = P::TR; o < 32; o <<= 1)
#pragma unroll
    for (int s = 0; s < P::RPT; ++s) u[s] += __shfl_xor_sync(FULL, u[s], o);
  if (P::NW > 1) {
    constexpr int WS = P::TR * P::RPT;
    float* p = part + buf * P::NW * WS;
    const int lane = tid & 31, warp = tid >> 5;
    if (lane < P::TR) {
#pragma unroll
      for (int s = 0; s < P::RPT; ++s) p[warp * WS + lane * P::RPT + s] = u[s];
    }
    grp_sync<P>();
    const int rg = tid % P::TR;
#pragma unroll
    for (int s = 0; s < P::RPT; ++s) {
      float acc = 0.f;
#pragma unroll
      for (int wp = 0; wp < P::NW; ++wp) acc += p[wp * WS + rg * P::RPT + s];
      u[s] = acc;
    }
    buf ^= 1;
  }
}

// Sum of one value per column group over all of them (norms).
template <class P>
__device__ __forceinline__ float allsum(float v, float* part, int& buf,
                                        int tid) {
#pragma unroll
  for (int o = P::TR; o < 32; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
  if (P::NW > 1) {
    float* p = part + buf * P::NW * P::TR * P::RPT;
    if ((tid & 31) == 0) p[tid >> 5] = v;
    grp_sync<P>();
    v = 0.f;
#pragma unroll
    for (int wp = 0; wp < P::NW; ++wp) v += p[wp];
    buf ^= 1;
  }
  return v;
}

// u = W v over the env, for the thread's rows.
template <class P>
__device__ __forceinline__ void wv(const float (&W)[P::RPT][P::CPT],
                                   const float (&v)[P::CPT],
                                   float (&u)[P::RPT], float* part, int& buf,
                                   int tid) {
#pragma unroll
  for (int s = 0; s < P::RPT; ++s) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < P::CPT; ++j) acc = fmaf(W[s][j], v[j], acc);
    u[s] = acc;
  }
  rowsum<P>(u, part, buf, tid);
}

// (W^T u)[slot j] over the env.
template <class P>
__device__ __forceinline__ float wtu(const float (&W)[P::RPT][P::CPT],
                                     const float (&u)[P::RPT], int j) {
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < P::RPT; ++s) acc = fmaf(W[s][j], u[s], acc);
  return colsum<P>(acc);
}

// Square root and quotient without the IEEE slow-path branches, for the
// iterative phases: x * rsqrt(x) and __fdividef are within 2 ulp for the
// normal-range operands they get here (sqrt of >= 1e-24 or 0; divisors
// clamped to >= 1e-12), and a branch in a sweep splits the code the
// scheduler can interleave.
__device__ __forceinline__ float fsqrt(float x) {
  return x > 0.f ? x * rsqrtf(x) : 0.f;
}

// The cone on one contact: (normal, t1, t2) -> its projection (the
// elliptic cone, or the L1 diamond when PYR), each row times its active
// flag.
template <bool PYR>
__device__ __forceinline__ void cone(float x0, float t1, float t2, float mu,
                                     float a0, float a1, float a2,
                                     float& l0, float& l1, float& l2) {
  float nrm = fmaxf(x0, 0.f);
  float lim = mu * nrm;
  float t1s, t2s;
  if (PYR) {
    float p1a = fabsf(t1), p2a = fabsf(t2);
    float xx = fminf(fmaxf((p1a - p2a + lim) * 0.5f, 0.f), lim);
    bool over = p1a + p2a > lim;
    float p1 = over ? xx : p1a;
    float p2 = over ? lim - xx : p2a;
    t1s = (t1 > 0.f ? p1 : (t1 < 0.f ? -p1 : 0.f));
    t2s = (t2 > 0.f ? p2 : (t2 < 0.f ? -p2 : 0.f));
  } else {
    float tn = fsqrt(t1 * t1 + t2 * t2 + 1e-24f);
    float scale = tn > lim ? __fdividef(lim, tn) : 1.f;
    t1s = t1 * scale;
    t2s = t2 * scale;
  }
  l0 = nrm * a0;
  l1 = t1s * a1;
  l2 = t2s * a2;
}

// lam = project(x) * active: the cone on each of the thread's contacts,
// >= 0 on its limit rows.
template <class P, bool PYR>
__device__ __forceinline__ void project(const float (&x)[P::CPT],
                                        const float (&act)[P::CPT],
                                        const float (&mu)[P::KC],
                                        float (&lam)[P::CPT]) {
#pragma unroll
  for (int q = 0; q < P::KC; ++q)
    cone<PYR>(x[3 * q], x[3 * q + 1], x[3 * q + 2], mu[q], act[3 * q],
              act[3 * q + 1], act[3 * q + 2], lam[3 * q], lam[3 * q + 1],
              lam[3 * q + 2]);
#pragma unroll
  for (int p = 3 * P::KC; p < P::CPT; ++p) lam[p] = fmaxf(x[p], 0.f) * act[p];
}

// J^T of env e into shared memory (nv rows, stride ldj), by the T
// threads of its block: copied on the explicit path, built from the
// contact-Jacobian parts on the parts path.
template <bool PARTS, int T>
__device__ __forceinline__ void stage_jt(const Args& a, long long e,
                                         float* Js, int ldj, int tid) {
  const int nv = a.nv, n = a.n, K = a.K, L = a.L;
  if (!PARTS) {
#pragma unroll 8
    for (int idx = tid; idx < nv * n; idx += T)
      Js[(idx / n) * ldj + idx % n] = a.JT[e * nv * n + idx];
  } else {
    // contact c, row r: J[rK+c, i] = (frame[c,r,:] . cd_lin[i] +
    // G[c,r,:] . cd_ang[i]) * w[c,i] with G[c,r,:] = rpos[c] x frame[c,r,:]
#pragma unroll 4
    for (int idx = tid; idx < K * nv; idx += T) {
      const int c = idx / nv, i = idx - c * nv;
      const float* fr = a.frame + (e * K + c) * 9;
      const float* rp = a.rpos + (e * K + c) * 3;
      const float* cl = a.cd_lin + (e * nv + i) * 3;
      const float* ca = a.cd_ang + (e * nv + i) * 3;
      const float wv = a.w[(e * K + c) * nv + i];
      const float rx = rp[0], ry = rp[1], rz = rp[2];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float fx = fr[3 * r], fy = fr[3 * r + 1], fz = fr[3 * r + 2];
        const float gx = ry * fz - rz * fy, gy = rz * fx - rx * fz,
                    gz = rx * fy - ry * fx;
        const float lin = fx * cl[0] + fy * cl[1] + fz * cl[2];
        const float ang = gx * ca[0] + gy * ca[1] + gz * ca[2];
        Js[i * ldj + r * K + c] = lin * wv + ang * wv;
      }
    }
#pragma unroll 4
    for (int idx = tid; idx < L * nv; idx += T) {
      const int l = idx / nv, i = idx - l * nv;
      Js[i * ldj + 3 * K + l] = i == a.ld_idx[l] ? a.sign_l[e * L + l] : 0.f;
    }
  }
}

template <class P, bool PARTS, bool PYR>
__global__ void __launch_bounds__(P::T) fused_solve_kernel(Args a) {
  constexpr int TR = P::TR, TC = P::TC, RPT = P::RPT, KC = P::KC;
  constexpr int CPT = P::CPT, MC = Smem<P>::MC, CS = Smem<P>::CS;
  extern __shared__ __align__(16) float fs_smem[];
  const int nv = a.nv, n = a.n, K = a.K, L = a.L;
  const int ldl = nv | 1, ldj = n | 1;
  float4* cv = reinterpret_cast<float4*>(fs_smem);  // column constants
  float* Js = fs_smem + 4 * TC * Smem<P>::CVS;      // J^T, staged
  float* Ls = Js + nv * ldj;                        // L, lower triangle
  float* inv_ld = Ls + nv * ldl;                    // 1 / L[k][k]
  float* ybuf = inv_ld + nv;                        // y = L^-1 qf
  float* tbuf = ybuf + nv;                          // t = W lam
  float* colbuf = tbuf + nv;                        // Cholesky columns
  float* part = colbuf + 2 * CS;                    // per-warp partials
  float* trash = part + Smem<P>::PART;              // non-owners' stores
  int buf = 0;

  const int tid = threadIdx.x;
  const int rg = tid % TR, cg = tid / TR;
  const int src0 = (tid & 31) & ~(TR - 1);  // lane of row group 0
  const long long e = blockIdx.x;
  const float4* cvp = cv + cg * Smem<P>::CVS;
  STAMP(0);

  // ---- 0. load: M into registers (rows as W's, columns cg + TC t), J^T
  // into shared memory, built there from the parts on that path ---------
  float A[RPT][MC];
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int i = rg + TR * s;
#pragma unroll
    for (int t = 0; t < MC; ++t) {
      const int k = cg + TC * t;
      A[s][t] = (i < nv && k < nv) ? a.M[(e * nv + i) * nv + k] : 0.f;
    }
  }
  stage_jt<PARTS, P::T>(a, e, Js, ldj, tid);
  float y[RPT];
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int i = rg + TR * s;
    y[s] = i < nv ? a.qf[e * nv + i] : 0.f;
  }
  STAMP(1);

  // ---- 1. Cholesky, right-looking, in registers --------------------------
  // For column j the owners (cg == j % TC) publish it unscaled (the
  // others store into the trash line); every thread scales the entries
  // it needs by d = 1/sqrt(pivot), zeroes those outside the trailing
  // rows and columns, and updates its entries of the trailing block
  // without a branch (entries above the diagonal are updated too and
  // never read). Two column buffers: one barrier per column. Column k of
  // A is final once j reaches k, so L = A d_k is written after the loop.
  int cb = 0;
#pragma unroll
  for (int jt = 0; jt < MC; ++jt) {
#pragma unroll 1
    for (int jc = 0; jc < TC; ++jc) {
      const int j = jc + TC * jt;
      if (j >= nv) break;
      float* col = colbuf + cb * CS;
      float* dst = cg == jc ? col + rg : trash + tid;
#pragma unroll
      for (int s = 0; s < RPT; ++s) dst[TR * s] = A[s][jt];
      grp_sync<P>();
      const float d = rsqrtf(fmaxf(col[j], 1e-12f));
      if (tid == 0) inv_ld[j] = d;
      float ci[RPT], ck[MC];
#pragma unroll
      for (int s = 0; s < RPT; ++s) {
        const int i = rg + TR * s;
        ci[s] = (i > j && i < nv) ? col[i] * d : 0.f;
      }
#pragma unroll
      for (int t = 0; t < MC; ++t) {
        const int k = cg + TC * t;
        ck[t] = k > j ? col[k] * d : 0.f;
      }
#pragma unroll
      for (int s = 0; s < RPT; ++s)
#pragma unroll
        for (int t = 0; t < MC; ++t) A[s][t] -= ci[s] * ck[t];
      cb ^= 1;
    }
  }
  grp_sync<P>();
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int i = rg + TR * s;
#pragma unroll
    for (int t = 0; t < MC; ++t) {
      const int k = cg + TC * t;
      if (k <= i && i < nv) Ls[i * ldl + k] = A[s][t] * inv_ld[k];
    }
  }
  grp_sync<P>();
  STAMP(2);

  // ---- 2. W = L^-1 J^T and y = L^-1 qf, right-looking ----------------
  // Row k = kr + TR ks lives in slot ks of row group kr: its owner scales
  // it, every thread takes it by __shfl and updates its rows below k.
  float W[RPT][CPT];
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int i = rg + TR * s;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = col_of<P>(j, cg, K, L);
      W[s][j] = (i < nv && c >= 0) ? Js[i * ldj + c] : 0.f;
    }
  }
#pragma unroll
  for (int ks = 0; ks < RPT; ++ks) {
#pragma unroll 1
    for (int kr = 0; kr < TR; ++kr) {
      const int k = kr + TR * ks;
      if (k >= nv) break;
      const float sc = rg == kr ? inv_ld[k] : 1.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) W[ks][j] *= sc;
      y[ks] *= sc;
      float wk[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        wk[j] = __shfl_sync(FULL, W[ks][j], src0 + kr);
      const float yk = __shfl_sync(FULL, y[ks], src0 + kr);
#pragma unroll
      for (int s = ks; s < RPT; ++s) {
        const int i = rg + TR * s;
        const float l =
            (i > k && i < nv) ? Ls[min(i, nv - 1) * ldl + k] : 0.f;
#pragma unroll
        for (int j = 0; j < CPT; ++j) W[s][j] = fmaf(-l, wk[j], W[s][j]);
        y[s] = fmaf(-l, yk, y[s]);
      }
    }
  }
  if (cg == 0) {
#pragma unroll
    for (int s = 0; s < RPT; ++s)
      if (rg + TR * s < nv) ybuf[rg + TR * s] = y[s];
  }
  STAMP(3);

  // ---- 3. diagA, R, inverse diagonal, b: the column constants ----------
  float lam[CPT], mu[KC];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    float sw = 0.f, sb = 0.f;
#pragma unroll
    for (int s = 0; s < RPT; ++s) {
      sw = fmaf(W[s][j], W[s][j], sw);
      sb = fmaf(W[s][j], y[s], sb);
    }
    sw = colsum<P>(sw);
    sb = colsum<P>(sb);
    const int c = col_of<P>(j, cg, K, L);
    const size_t o = e * n + c;
    const float diagA = fmaxf(sw, 1e-8f);
    const float im = c >= 0 ? fminf(fmaxf(a.imp[o], 1e-5f), 1.f - 1e-5f) : 0.5f;
    const float r = (1.f - im) / im * diagA;
    if (rg == 0)
      cv[cg * Smem<P>::CVS + j] =
          make_float4(r, 1.f / fmaxf(diagA + r, 1e-8f),
                      sb - (c >= 0 ? a.aref[o] : 0.f),
                      c >= 0 ? a.active[o] : 0.f);
    lam[j] = c >= 0 ? a.lam0[o] : 0.f;  // the warm start, projected below
  }
#pragma unroll
  for (int q = 0; q < KC; ++q) {
    const int c = cg + TC * q;
    mu[q] = c < K ? a.mu[e * K + c] : 0.f;
  }
  grp_sync<P>();
  STAMP(4);

  // ---- 4. power iteration for the step size -----------------------------
  float vec[CPT], v[CPT], u[RPT];
  {
    float s2 = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      vec[j] = cvp[j].w;
      s2 = fmaf(vec[j], vec[j], s2);
    }
    const float anrm = fmaxf(fsqrt(allsum<P>(s2, part, buf, tid)), 1e-12f);
#pragma unroll
    for (int j = 0; j < CPT; ++j) vec[j] = __fdividef(vec[j], anrm);
  }
  float lam_max = 1.f;
#pragma unroll 1
  for (int it = 0; it <= POWER_ITERS; ++it) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) v[j] = vec[j] * cvp[j].w;
    wv<P>(W, v, u, part, buf, tid);
    float s2 = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float4 c = cvp[j];
      const float g = wtu<P>(W, u, j) + c.x * v[j];
      vec[j] = c.y * g * c.w;
      s2 = fmaf(vec[j], vec[j], s2);
    }
    // the last pass only reads the norm: lam_max keeps its value
    const float nrm = fsqrt(allsum<P>(s2, part, buf, tid));
    const float dn = fmaxf(nrm, 1e-12f);
#pragma unroll
    for (int j = 0; j < CPT; ++j) vec[j] = __fdividef(vec[j], dn);
    lam_max = fmaxf(nrm, 1.f);
  }
  const float step = fminf(1.5f / lam_max, 1.f);
  STAMP(5);

  // ---- 5. projected sweeps from project(lam0) ---------------------------
  {
    float ac[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) ac[j] = cvp[j].w;
    project<P, PYR>(lam, ac, mu, lam);
  }
#pragma unroll 1
  for (int it = 0; it < a.iterations; ++it) {
    wv<P>(W, lam, u, part, buf, tid);
    float x[CPT], ac[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float4 c = cvp[j];
      const float g = wtu<P>(W, u, j) + c.x * lam[j];
      x[j] = lam[j] - step * c.y * (g + c.z);
      ac[j] = c.w;
    }
    project<P, PYR>(x, ac, mu, lam);
  }
  STAMP(6);

  // ---- 6. outputs ---------------------------------------------------------
  wv<P>(W, lam, u, part, buf, tid);  // t = W lam
  if (cg == 0) {
#pragma unroll
    for (int s = 0; s < RPT; ++s)
      if (rg + TR * s < nv) tbuf[rg + TR * s] = u[s];
  }
  if (rg == 0) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = col_of<P>(j, cg, K, L);
      if (c >= 0) a.lam[e * n + c] = lam[j];
    }
  }
  grp_sync<P>();
  // qfrc = L t = J^T lam: column group cg takes k = cg, cg + TC, ...
  float z[RPT];
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int i = rg + TR * s;
    const float* Lr = Ls + min(i, nv - 1) * ldl;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < MC; ++t) {
      const int k = cg + TC * t;
      acc += (k <= i && i < nv) ? Lr[k] * tbuf[k] : 0.f;
    }
    z[s] = acc;
  }
  rowsum<P>(z, part, buf, tid);
  if (cg == 0) {
#pragma unroll
    for (int s = 0; s < RPT; ++s)
      if (rg + TR * s < nv) a.qfrc[e * nv + rg + TR * s] = z[s];
  }
  // qacc = L^-T (y + t), right-looking from the last row up
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int i = rg + TR * s;
    z[s] = i < nv ? ybuf[i] + u[s] : 0.f;
  }
#pragma unroll
  for (int ks = RPT - 1; ks >= 0; --ks) {
#pragma unroll 1
    for (int kr = TR - 1; kr >= 0; --kr) {
      const int k = kr + TR * ks;
      if (k < nv) {
        z[ks] *= rg == kr ? inv_ld[k] : 1.f;
        const float zk = __shfl_sync(FULL, z[ks], src0 + kr);
#pragma unroll
        for (int s = 0; s <= ks; ++s) {
          const int i = rg + TR * s;
          const float l = i < k ? Ls[k * ldl + i] : 0.f;
          z[s] = fmaf(-l, zk, z[s]);
        }
      }
    }
  }
  if (cg == 0) {
#pragma unroll
    for (int s = 0; s < RPT; ++s)
      if (rg + TR * s < nv) a.qacc[e * nv + rg + TR * s] = z[s];
  }
  STAMP(7);
}

// ---- the shared-memory plan ----------------------------------------------
// For the sizes no register plan holds (more constraint rows than
// REG_N_MAX: G1 from 26 contact slots, humanoid3d from 29): one block of
// T threads per env, with W = L^-1 J^T in shared memory, written in place
// over the staged J^T. Its limit is the shared memory of one block
// (Shared::floats): G1 at 128 slots (n 421) takes ~89 KB, two blocks an
// SM. The pipeline and the arithmetic are the register kernel's:
//   - thread t owns the units t, t + T, ...: unit c < K is contact c (the
//     columns c, K + c, 2K + c: normal and both tangents, so the cone
//     projection needs no exchange), unit K + l the limit row 3K + l;
//   - Cholesky runs in place in shared memory, right-looking, one barrier
//     per column; W and y are forward substitutions, one column per
//     thread (y on the last thread), with no barrier;
//   - W v: warp w takes rows w, w + NW, ...; its lanes stride the columns
//     and a butterfly of shuffles sums them. W^T u: each thread sums its
//     own columns over the nv rows (u is a broadcast read). Norms are a
//     block sum: shuffles, then one shared-memory pass across the warps;
//   - the vector W v multiplies (the power iterate, then lam) lives in
//     shared memory; a sweep takes two barriers.
// It reads W from shared memory twice per matvec, so the shared-memory
// rate, not the fp32 rate, sets its pace.
template <int T>
struct Shared {
  static constexpr int NW = T / 32;
  // per column {R, 1/diag, b, active} as float4s (n), W (nv rows, stride
  // n|1), L (nv rows, stride nv|1), 1/L_kk, y, u = W v, the vector W v
  // multiplies (n), mu (K), two buffers of per-warp partials
  __host__ __device__ static constexpr int floats(int nv, int n, int K) {
    return 4 * n + nv * (n | 1) + nv * (nv | 1) + 3 * nv + n + K + 2 * NW;
  }
};

// Sum of one value per thread over the block.
template <int T>
__device__ __forceinline__ float block_sum(float v, float* red, int& buf,
                                           int tid) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  float* p = red + buf * Shared<T>::NW;
  if ((tid & 31) == 0) p[tid >> 5] = v;
  __syncthreads();
  v = 0.f;
#pragma unroll
  for (int w = 0; w < Shared<T>::NW; ++w) v += p[w];
  buf ^= 1;
  return v;
}

// u = W v; ends with a barrier, so u is read after it.
template <int T>
__device__ __forceinline__ void wv_rows(const float* Ws, int ldw,
                                        const float* v, float* u, int nv,
                                        int n, int tid) {
  const int lane = tid & 31;
  for (int i = tid >> 5; i < nv; i += Shared<T>::NW) {
    const float* w = Ws + i * ldw;
    float a0 = 0.f, a1 = 0.f;
    int j = lane;
    for (; j + 32 < n; j += 64) {
      a0 = fmaf(w[j], v[j], a0);
      a1 = fmaf(w[j + 32], v[j + 32], a1);
    }
    if (j < n) a0 = fmaf(w[j], v[j], a0);
    float acc = a0 + a1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
    if (lane == 0) u[i] = acc;
  }
  __syncthreads();
}

// The NC columns c[] of X (rows of stride ldx) become L^-1 X, one thread.
template <int NC>
__device__ __forceinline__ void fwd_cols(const float* Ls, int ldl,
                                         const float* inv_ld, int nv,
                                         float* X, int ldx,
                                         const int (&c)[NC]) {
  for (int k = 0; k < nv; ++k) {
    const float* lk = Ls + k * ldl;
    float s[NC];
#pragma unroll
    for (int q = 0; q < NC; ++q) s[q] = X[k * ldx + c[q]];
    for (int m = 0; m < k; ++m) {
      const float l = lk[m];
#pragma unroll
      for (int q = 0; q < NC; ++q) s[q] = fmaf(-l, X[m * ldx + c[q]], s[q]);
    }
    const float d = inv_ld[k];
#pragma unroll
    for (int q = 0; q < NC; ++q) X[k * ldx + c[q]] = s[q] * d;
  }
}

// (W^T u)[c[q]] for the NC columns c[] of W.
template <int NC>
__device__ __forceinline__ void wtu_cols(const float* Ws, int ldw,
                                         const float* u, int nv,
                                         const int (&c)[NC], float (&g)[NC]) {
#pragma unroll
  for (int q = 0; q < NC; ++q) g[q] = 0.f;
  for (int i = 0; i < nv; ++i) {
    const float ui = u[i];
    const float* w = Ws + i * ldw;
#pragma unroll
    for (int q = 0; q < NC; ++q) g[q] = fmaf(w[c[q]], ui, g[q]);
  }
}

// The column constants {R, 1/diag, b, active} of the NC columns c[]; adds
// each column's active^2 to s2 (the power iteration's start).
template <int NC>
__device__ __forceinline__ void col_consts(const Args& a, long long e,
                                           const float* Ws, int ldw,
                                           const float* y, float4* cv,
                                           const int (&c)[NC], float& s2) {
  float sw[NC], sb[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) sw[q] = sb[q] = 0.f;
  for (int i = 0; i < a.nv; ++i) {
    const float* w = Ws + i * ldw;
    const float yi = y[i];
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      sw[q] = fmaf(w[c[q]], w[c[q]], sw[q]);
      sb[q] = fmaf(w[c[q]], yi, sb[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const size_t o = e * a.n + c[q];
    const float diagA = fmaxf(sw[q], 1e-8f);
    const float im = fminf(fmaxf(a.imp[o], 1e-5f), 1.f - 1e-5f);
    const float r = (1.f - im) / im * diagA;
    const float act = a.active[o];
    cv[c[q]] = make_float4(r, 1.f / fmaxf(diagA + r, 1e-8f),
                           sb[q] - a.aref[o], act);
    s2 = fmaf(act, act, s2);
  }
}

template <int T, bool PARTS, bool PYR>
__global__ void __launch_bounds__(T) fused_solve_shared_kernel(Args a) {
  extern __shared__ __align__(16) float fs_smem[];
  const int nv = a.nv, n = a.n, K = a.K, L = a.L, U = K + L;
  const int ldl = nv | 1, ldw = n | 1;
  float4* cv = reinterpret_cast<float4*>(fs_smem);  // column constants
  float* Ws = fs_smem + 4 * n;                      // J^T, then W
  float* Ls = Ws + nv * ldw;                        // M, then L
  float* inv_ld = Ls + nv * ldl;                    // 1 / L[k][k]
  float* ybuf = inv_ld + nv;                        // y = L^-1 qf
  float* ubuf = ybuf + nv;                          // u = W v
  float* vbuf = ubuf + nv;                          // v, then lam
  float* mus = vbuf + n;                            // mu
  float* red = mus + K;                             // per-warp partials
  int buf = 0;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long e = blockIdx.x;
  STAMP(0);

  // ---- 0. load: M, J^T (built from the parts on that path), mu ----------
  for (int idx = tid; idx < nv * nv; idx += T)
    Ls[(idx / nv) * ldl + idx % nv] = a.M[e * nv * nv + idx];
  stage_jt<PARTS, T>(a, e, Ws, ldw, tid);
  for (int c = tid; c < K; c += T) mus[c] = a.mu[e * K + c];
  __syncthreads();
  STAMP(1);

  // ---- 1. Cholesky, right-looking, in place ------------------------------
  // Column j is final when step j starts: each thread scales the entries
  // it needs by d = 1/sqrt(pivot) and updates its share of the trailing
  // lower triangle. Column k is scaled by 1/L_kk after the loop.
  for (int j = 0; j < nv; ++j) {
    const float d = rsqrtf(fmaxf(Ls[j * ldl + j], 1e-12f));
    if (tid == 0) inv_ld[j] = d;
    const int m = nv - 1 - j;
    for (int idx = tid; idx < m * m; idx += T) {
      const int i = j + 1 + idx / m, k = j + 1 + idx % m;
      if (k <= i)
        Ls[i * ldl + k] -= (Ls[i * ldl + j] * d) * (Ls[k * ldl + j] * d);
    }
    __syncthreads();
  }
  for (int idx = tid; idx < nv * nv; idx += T) {
    const int i = idx / nv, k = idx - (idx / nv) * nv;
    if (k <= i) Ls[i * ldl + k] *= inv_ld[k];
  }
  __syncthreads();
  STAMP(2);

  // ---- 2. W = L^-1 J^T by columns, y = L^-1 qf on the last thread --------
  for (int u = tid; u < U; u += T) {
    if (u < K) {
      const int c[3] = {u, K + u, 2 * K + u};
      fwd_cols<3>(Ls, ldl, inv_ld, nv, Ws, ldw, c);
    } else {
      const int c[1] = {2 * K + u};
      fwd_cols<1>(Ls, ldl, inv_ld, nv, Ws, ldw, c);
    }
  }
  if (tid == T - 1) {
    for (int i = 0; i < nv; ++i) ybuf[i] = a.qf[e * nv + i];
    const int c[1] = {0};
    fwd_cols<1>(Ls, ldl, inv_ld, nv, ybuf, 1, c);
  }
  __syncthreads();
  STAMP(3);

  // ---- 3. diagA, R, inverse diagonal, b: the column constants ------------
  float s2 = 0.f;
  for (int u = tid; u < U; u += T) {
    if (u < K) {
      const int c[3] = {u, K + u, 2 * K + u};
      col_consts<3>(a, e, Ws, ldw, ybuf, cv, c, s2);
    } else {
      const int c[1] = {2 * K + u};
      col_consts<1>(a, e, Ws, ldw, ybuf, cv, c, s2);
    }
  }
  STAMP(4);

  // ---- 4. power iteration for the step size -----------------------------
  // vbuf holds v = vec * active; each thread writes its own columns
  {
    const float anrm = fmaxf(fsqrt(block_sum<T>(s2, red, buf, tid)), 1e-12f);
    for (int c = tid; c < n; c += T) {
      const float act = cv[c].w;
      vbuf[c] = __fdividef(act, anrm) * act;
    }
  }
  float lam_max = 1.f;
  for (int it = 0; it <= POWER_ITERS; ++it) {
    __syncthreads();
    wv_rows<T>(Ws, ldw, vbuf, ubuf, nv, n, tid);
    float p2 = 0.f;
    for (int u = tid; u < U; u += T) {
      if (u < K) {
        const int c[3] = {u, K + u, 2 * K + u};
        float g[3];
        wtu_cols<3>(Ws, ldw, ubuf, nv, c, g);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float4 k = cv[c[q]];
          const float vec = k.y * (g[q] + k.x * vbuf[c[q]]) * k.w;
          vbuf[c[q]] = vec;
          p2 = fmaf(vec, vec, p2);
        }
      } else {
        const int c[1] = {2 * K + u};
        float g[1];
        wtu_cols<1>(Ws, ldw, ubuf, nv, c, g);
        const float4 k = cv[c[0]];
        const float vec = k.y * (g[0] + k.x * vbuf[c[0]]) * k.w;
        vbuf[c[0]] = vec;
        p2 = fmaf(vec, vec, p2);
      }
    }
    // the last pass only reads the norm: lam_max keeps its value
    const float nrm = fsqrt(block_sum<T>(p2, red, buf, tid));
    const float dn = fmaxf(nrm, 1e-12f);
    for (int c = tid; c < n; c += T) vbuf[c] = __fdividef(vbuf[c], dn) *
                                               cv[c].w;
    lam_max = fmaxf(nrm, 1.f);
  }
  const float step = fminf(1.5f / lam_max, 1.f);
  __syncthreads();
  STAMP(5);

  // ---- 5. projected sweeps from project(lam0) ---------------------------
  for (int u = tid; u < U; u += T) {
    const long long o = e * n;
    if (u < K) {
      const int c0 = u, c1 = K + u, c2 = 2 * K + u;
      cone<PYR>(a.lam0[o + c0], a.lam0[o + c1], a.lam0[o + c2], mus[u],
                cv[c0].w, cv[c1].w, cv[c2].w, vbuf[c0], vbuf[c1], vbuf[c2]);
    } else {
      const int c = 2 * K + u;
      vbuf[c] = fmaxf(a.lam0[o + c], 0.f) * cv[c].w;
    }
  }
  for (int it = 0; it < a.iterations; ++it) {
    __syncthreads();
    wv_rows<T>(Ws, ldw, vbuf, ubuf, nv, n, tid);
    for (int u = tid; u < U; u += T) {
      if (u < K) {
        const int c[3] = {u, K + u, 2 * K + u};
        float g[3], x[3], ac[3];
        wtu_cols<3>(Ws, ldw, ubuf, nv, c, g);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float4 k = cv[c[q]];
          const float lq = vbuf[c[q]];
          x[q] = lq - step * k.y * (g[q] + k.x * lq + k.z);
          ac[q] = k.w;
        }
        cone<PYR>(x[0], x[1], x[2], mus[u], ac[0], ac[1], ac[2], vbuf[c[0]],
                  vbuf[c[1]], vbuf[c[2]]);
      } else {
        const int c[1] = {2 * K + u};
        float g[1];
        wtu_cols<1>(Ws, ldw, ubuf, nv, c, g);
        const float4 k = cv[c[0]];
        const float lq = vbuf[c[0]];
        const float x = lq - step * k.y * (g[0] + k.x * lq + k.z);
        vbuf[c[0]] = fmaxf(x, 0.f) * k.w;
      }
    }
  }
  __syncthreads();
  STAMP(6);

  // ---- 6. outputs ---------------------------------------------------------
  wv_rows<T>(Ws, ldw, vbuf, ubuf, nv, n, tid);  // t = W lam
  for (int c = tid; c < n; c += T) a.lam[e * n + c] = vbuf[c];
  // qfrc = L t = J^T lam, a row a thread
  for (int i = tid; i < nv; i += T) {
    const float* li = Ls + i * ldl;
    float acc = 0.f;
    for (int k = 0; k <= i; ++k) acc = fmaf(li[k], ubuf[k], acc);
    a.qfrc[e * nv + i] = acc;
  }
  // qacc = L^-T (y + t), right-looking from the last row up, on warp 0
  if (tid < 32) {
    for (int i = lane; i < nv; i += 32) ybuf[i] += ubuf[i];
    __syncwarp();
    for (int k = nv - 1; k >= 0; --k) {
      const float zk = ybuf[k] * inv_ld[k];
      const float* lk = Ls + k * ldl;
      for (int i = lane; i < k; i += 32) ybuf[i] = fmaf(-lk[i], zk, ybuf[i]);
      if (lane == 0) a.qacc[e * nv + k] = zk;
      __syncwarp();
    }
  }
  STAMP(7);
}

template <class P>
static bool plan_is(int tr, int tc, int rpt, int kc, int lc) {
  return tr == P::TR && tc == P::TC && rpt == P::RPT && kc == P::KC &&
         lc == P::LC;
}

template <class P>
static const void* kernel_of(bool parts, bool pyr) {
  if (parts)
    return pyr ? (const void*)fused_solve_kernel<P, true, true>
               : (const void*)fused_solve_kernel<P, true, false>;
  return pyr ? (const void*)fused_solve_kernel<P, false, true>
             : (const void*)fused_solve_kernel<P, false, false>;
}

template <class P>
static int launch(const Args& a, int B, bool parts, cudaStream_t stream) {
  if (a.nv > P::TR * P::RPT || a.K > P::TC * P::KC || a.L > P::TC * P::LC)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * Smem<P>::floats(a.nv, a.n);
  const bool pyr = a.pyramidal != 0;
  const void* kern = kernel_of<P>(parts, pyr);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (parts && pyr)
    fused_solve_kernel<P, true, true><<<B, P::T, smem, stream>>>(a);
  else if (parts)
    fused_solve_kernel<P, true, false><<<B, P::T, smem, stream>>>(a);
  else if (pyr)
    fused_solve_kernel<P, false, true><<<B, P::T, smem, stream>>>(a);
  else
    fused_solve_kernel<P, false, false><<<B, P::T, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The shared-memory plan's thread counts (ops/fused_solve.py:
// SHARED_PLANS); its plan tuple is (0, T, 0, 0, 0).
#define FUSED_SOLVE_SHARED(X) X(128) X(256)

template <int T>
static const void* shared_kernel_of(bool parts, bool pyr) {
  if (parts)
    return pyr ? (const void*)fused_solve_shared_kernel<T, true, true>
               : (const void*)fused_solve_shared_kernel<T, true, false>;
  return pyr ? (const void*)fused_solve_shared_kernel<T, false, true>
             : (const void*)fused_solve_shared_kernel<T, false, false>;
}

template <int T>
static int launch_shared(const Args& a, int B, bool parts,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float) * Shared<T>::floats(a.nv, a.n, a.K);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const bool pyr = a.pyramidal != 0;
  const void* kern = shared_kernel_of<T>(parts, pyr);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (parts && pyr)
    fused_solve_shared_kernel<T, true, true><<<B, T, smem, stream>>>(a);
  else if (parts)
    fused_solve_shared_kernel<T, true, false><<<B, T, smem, stream>>>(a);
  else if (pyr)
    fused_solve_shared_kernel<T, false, true><<<B, T, smem, stream>>>(a);
  else
    fused_solve_shared_kernel<T, false, false><<<B, T, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// One launch of B envs. JT == NULL selects the parts path (cd_lin ...
// ld_idx); otherwise the parts pointers are ignored. clocks is read only
// by the -DFUSED_SOLVE_CLOCKS build. (tr, tc, rpt, kc, lc) is one of
// FUSED_SOLVE_PLANS, within the register plans' range, or (0, T, 0, 0, 0)
// with T one of FUSED_SOLVE_SHARED, within one block's shared memory.
extern "C" int fused_solve_launch(
    const void* M, const void* JT, const void* cd_lin, const void* cd_ang,
    const void* frame, const void* rpos, const void* w, const void* sign_l,
    const void* ld_idx, const void* qf, const void* aref, const void* imp,
    const void* active, const void* mu, const void* lam0, void* qacc,
    void* qfrc, void* lam, void* clocks, int B, int nv, int n, int K, int L,
    int iterations, int pyramidal, int tr, int tc, int rpt, int kc, int lc,
    void* stream) {
  if (nv < 1 || n != 3 * K + L || K < 0 || L < 0 || B < 0 || iterations < 0)
    return (int)cudaErrorInvalidValue;
  if (tr != 0 && (nv > REG_NV_MAX || n > REG_N_MAX || K > REG_K_MAX))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a;
  a.M = (const float*)M;
  a.JT = (const float*)JT;
  a.cd_lin = (const float*)cd_lin;
  a.cd_ang = (const float*)cd_ang;
  a.frame = (const float*)frame;
  a.rpos = (const float*)rpos;
  a.w = (const float*)w;
  a.sign_l = (const float*)sign_l;
  a.ld_idx = (const int*)ld_idx;
  a.qf = (const float*)qf;
  a.aref = (const float*)aref;
  a.imp = (const float*)imp;
  a.active = (const float*)active;
  a.mu = (const float*)mu;
  a.lam0 = (const float*)lam0;
  a.qacc = (float*)qacc;
  a.qfrc = (float*)qfrc;
  a.lam = (float*)lam;
  a.clocks = (long long*)clocks;
  a.nv = nv;
  a.n = n;
  a.K = K;
  a.L = L;
  a.iterations = iterations;
  a.pyramidal = pyramidal;
  const bool parts = JT == nullptr;
  cudaStream_t st = (cudaStream_t)stream;
#define FS_DISPATCH(tr_, tc_, rpt_, kc_, lc_)                    \
  if (plan_is<Plan<tr_, tc_, rpt_, kc_, lc_>>(tr, tc, rpt, kc, lc)) \
    return launch<Plan<tr_, tc_, rpt_, kc_, lc_>>(a, B, parts, st);
  FUSED_SOLVE_PLANS(FS_DISPATCH)
#undef FS_DISPATCH
#define FS_DISPATCH_SHARED(t_)                                  \
  if (tr == 0 && tc == t_ && rpt == 0 && kc == 0 && lc == 0) \
    return launch_shared<t_>(a, B, parts, st);
  FUSED_SOLVE_SHARED(FS_DISPATCH_SHARED)
#undef FS_DISPATCH_SHARED
  return (int)cudaErrorInvalidValue;
}

// What the compiler and the occupancy calculator say of one plan's
// kernel: out = {registers per thread, local (spill) bytes per thread,
// dynamic shared bytes at (nv, n, K), blocks per SM}.
static int kernel_report(const void* kern, int threads, int smem, int* out) {
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, kern);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  out[2] = smem;
  out[3] = blocks;
  return 0;
}

extern "C" int fused_solve_info(int tr, int tc, int rpt, int kc, int lc,
                                int parts, int nv, int n, int K, int* out) {
#define FS_INFO(tr_, tc_, rpt_, kc_, lc_)                                  \
  if (plan_is<Plan<tr_, tc_, rpt_, kc_, lc_>>(tr, tc, rpt, kc, lc)) {      \
    using P = Plan<tr_, tc_, rpt_, kc_, lc_>;                              \
    return kernel_report(kernel_of<P>(parts != 0, false), P::T,            \
                         (int)sizeof(float) * Smem<P>::floats(nv, n), out); \
  }
  FUSED_SOLVE_PLANS(FS_INFO)
#undef FS_INFO
#define FS_INFO_SHARED(t_)                                                 \
  if (tr == 0 && tc == t_ && rpt == 0 && kc == 0 && lc == 0)               \
    return kernel_report(shared_kernel_of<t_>(parts != 0, false), t_,      \
                         (int)sizeof(float) * Shared<t_>::floats(nv, n, K), \
                         out);
  FUSED_SOLVE_SHARED(FS_INFO_SHARED)
#undef FS_INFO_SHARED
  return (int)cudaErrorInvalidValue;
}
