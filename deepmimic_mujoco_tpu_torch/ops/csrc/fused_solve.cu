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
// Sizes that no register plan holds (more than REG_N_MAX constraint
// rows) take the shared-memory plan, fused_solve_shared_kernel below: the
// same grid and pipeline with W split between registers and shared
// memory, up to what one block's shared memory holds (Split::floats,
// mirrored by ops/fused_solve.py:shared_smem_bytes).
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

// (index, TR, TC, RPT, KC, LC): the plans the kernel is compiled for, in
// the order launch_plan tries them (ops/fused_solve.py:PLANS). The index
// (shared with FUSED_SOLVE_SHARED) picks the translation unit that builds
// the plan (FS_SHARD, below).
#define FUSED_SOLVE_PLANS(X) \
  X(0, 4, 8, 9, 2, 4)        \
  X(1, 4, 16, 11, 2, 3)      \
  X(2, 4, 32, 12, 2, 2)

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
// REG_N_MAX: G1 from 26 contact slots, humanoid3d from 29): one block per
// env on the register kernel's thread grid, with W split between the
// registers and shared memory. Thread (rg, cg) owns the rows rg + TR s
// (s < RPT) and the columns of its units: contact c = cg + TC q (the
// columns c, K + c, 2K + c, so the cone needs no exchange) and limit row
// 3K + l with l = TC - 1 - cg + TC p (dealt from the last column group,
// so no two column groups differ by more than one unit):
//   - its first KR contacts and LR limits (CR = 3 KR + LR columns) hold
//     W in registers, as in a register plan; the rest (QS contacts and PS
//     limits, SC = 3 QS + PS columns, counts that K and L set at run
//     time) hold W in shared memory, each thread its own slots, laid out
//     so that a warp reads 32 consecutive floats. Each thread also keeps
//     the vector W v multiplies for those columns in its own slots;
//   - W^T u reduces over the row groups as in the register kernel
//     (colsum); W v over the column groups by rowsum_rs, a reduce-scatter
//     of the rows across a warp's column groups, one shared-memory pass
//     over the warps and a gather: no single-thread or per-row serial
//     phase, one barrier a sweep (two a power iteration, for the norm);
//   - a sweep works the shared columns two contacts (or two limit rows)
//     at a time, a power iteration three columns at a time: their loads
//     and sums interleave, then their projections follow;
//   - Cholesky in registers and W = L^-1 J^T right-looking, as in the
//     register kernel (L kept transposed, so a step reads it at fixed
//     offsets): the shared columns a chunk of CR at a time through the
//     registers the W tile takes later, then the register columns with y;
//     J is read or built from the parts straight into its owner's slots
//     or registers (no staged copy of J^T), the latter row by row;
//   - the column constants {R, 1/diag, b, active} of slot j of column
//     group cg lie at cv[j TC + cg], so a warp's 8 column groups read one
//     128-byte line.
// Shared memory holds the shared part of W, so it bounds what one env may
// take (Split::floats, mirrored by ops/fused_solve.py:shared_smem_bytes);
// the pace is set by the envs an SM holds (three: 168 registers a
// thread) and by each env's chain of steps, as in the register kernel.
// Each instance is a register tile (RPT rows x CR columns) and a floor on
// blocks per SM for ptxas; every one must build without a spill.
template <int TC_, int RPT_, int KR_, int LR_, int MINB_>
struct Split {
  using P = Plan<4, TC_, RPT_, KR_, LR_>;  // the register part's grid
  static constexpr int TR = P::TR, TC = P::TC, T = P::T, RPT = RPT_;
  static constexpr int KR = KR_, LR = LR_, CR = P::CPT, MINB = MINB_;
  // one buffer of per-warp row partials (rowsum_rs: 16 rows a row group)
  static constexpr int PART = (T / 32) * TR * 16;
  // contact and limit slots a column group holds in shared memory
  __host__ __device__ static constexpr int qs(int K) {
    return (K + TC - 1) / TC > KR ? (K + TC - 1) / TC - KR : 0;
  }
  __host__ __device__ static constexpr int ps(int L) {
    return (L + TC - 1) / TC > LR ? (L + TC - 1) / TC - LR : 0;
  }
  // the column constants (float4, every slot of every column group), W's
  // shared part, each thread's slots of the vector, mu of every contact
  // slot, then the register kernel's L (transposed), 1/L_kk, y and t, and
  // two buffers of warp partials, which hold the Cholesky's column
  // buffers and trash line before the first reduction
  __host__ __device__ static constexpr int floats(int nv, int K, int L) {
    return 4 * TC * (CR + 3 * qs(K) + ps(L)) +
           (3 * qs(K) + ps(L)) * (RPT * T + T) + (KR + qs(K)) * TC +
           nv * (nv | 1) + 3 * nv + 2 * PART;
  }
  static_assert(2 * PART >= 2 * Smem<P>::CS + Smem<P>::TRASH,
                "the Cholesky's buffers fit the partials' room");
};

// (index, TC, RPT, KR, LR, MINB): the instances (ops/fused_solve.py:
// SHARED_PLANS, where launch_plan picks one by nv, K and L): humanoid3d
// (nv <= 36), G1 (nv <= 44; all of W in registers up to 32 contact
// slots, then two contacts a thread) and any nv up to 64. MINB 3 caps a
// thread at 168 registers: three envs an SM.
#define FUSED_SOLVE_SHARED(X)                                        \
  X(3, 32, 9, 2, 1, 3) X(4, 32, 11, 1, 2, 3) X(5, 32, 11, 2, 0, 3)  \
  X(6, 32, 16, 1, 0, 2)

// The contact frame of contact c and G = rpos x frame (its rows), for the
// parts path.
__device__ __forceinline__ void contact_frame(const Args& a, long long e,
                                              int c, float (&fr)[9],
                                              float (&g)[9]) {
  const float* f = a.frame + (e * a.K + c) * 9;
  const float* rp = a.rpos + (e * a.K + c) * 3;
#pragma unroll
  for (int q = 0; q < 9; ++q) fr[q] = f[q];
  const float rx = rp[0], ry = rp[1], rz = rp[2];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float fx = fr[3 * r], fy = fr[3 * r + 1], fz = fr[3 * r + 2];
    g[3 * r] = ry * fz - rz * fy;
    g[3 * r + 1] = rz * fx - rx * fz;
    g[3 * r + 2] = rx * fy - ry * fx;
  }
}

// J^T[i][rK + c], r = 0, 1, 2: contact c at dof i (i < nv, c < K), read
// on the explicit path, built as stage_jt builds it on the parts path.
template <bool PARTS>
__device__ __forceinline__ void jt_contact(const Args& a, long long e, int c,
                                           int i, const float (&fr)[9],
                                           const float (&g)[9],
                                           float (&out)[3]) {
  if (!PARTS) {
    const float* row = a.JT + (e * a.nv + i) * a.n + c;
#pragma unroll
    for (int r = 0; r < 3; ++r) out[r] = row[r * a.K];
  } else {
    const float* cl = a.cd_lin + (e * a.nv + i) * 3;
    const float* ca = a.cd_ang + (e * a.nv + i) * 3;
    const float wv = a.w[(e * a.K + c) * a.nv + i];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float lin =
          fr[3 * r] * cl[0] + fr[3 * r + 1] * cl[1] + fr[3 * r + 2] * cl[2];
      const float ang =
          g[3 * r] * ca[0] + g[3 * r + 1] * ca[1] + g[3 * r + 2] * ca[2];
      out[r] = lin * wv + ang * wv;
    }
  }
}

// J^T[i][3K + l]: limit row l at dof i.
template <bool PARTS>
__device__ __forceinline__ float jt_limit(const Args& a, long long e, int l,
                                          int i) {
  if (!PARTS) return a.JT[(e * a.nv + i) * a.n + 3 * a.K + l];
  return i == a.ld_idx[l] ? a.sign_l[e * a.L + l] : 0.f;
}

// J of contact c (its three columns) or of limit row l (one) for a
// thread's rows, into its shared slots from w (column j, row slot s at
// w[(j RPT + s) T]); zero outside the env.
template <class S, bool PARTS>
__device__ __forceinline__ void store_contact(const Args& a, long long e,
                                              int c, int rg, float* w) {
  float fr[9], g[9];
  if (PARTS && c < a.K) contact_frame(a, e, c, fr, g);
#pragma unroll
  for (int s = 0; s < S::RPT; ++s) {
    const int i = rg + S::TR * s;
    float v[3] = {0.f, 0.f, 0.f};
    if (c < a.K && i < a.nv) jt_contact<PARTS>(a, e, c, i, fr, g, v);
#pragma unroll
    for (int r = 0; r < 3; ++r) w[(r * S::RPT + s) * S::T] = v[r];
  }
}

template <class S, bool PARTS>
__device__ __forceinline__ void store_limit(const Args& a, long long e, int l,
                                            int rg, float* w) {
#pragma unroll
  for (int s = 0; s < S::RPT; ++s) {
    const int i = rg + S::TR * s;
    w[s * S::T] = (l < a.L && i < a.nv) ? jt_limit<PARTS>(a, e, l, i) : 0.f;
  }
}

// The register columns of a thread (its first KR contacts, then its first
// LR limit rows) into W, row by row: each row of cd_lin and cd_ang is
// read once for all of the thread's contacts.
template <class S, bool PARTS>
__device__ __forceinline__ void load_registers(const Args& a, long long e,
                                               int cg, int rg,
                                               float (&W)[S::RPT][S::CR]) {
  float fr[S::KR][9], g[S::KR][9];
#pragma unroll
  for (int q = 0; q < S::KR; ++q)
    if (PARTS && cg + S::TC * q < a.K)
      contact_frame(a, e, cg + S::TC * q, fr[q], g[q]);
#pragma unroll
  for (int s = 0; s < S::RPT; ++s) {
    const int i = rg + S::TR * s;
#pragma unroll
    for (int q = 0; q < S::KR; ++q) {
      const int c = cg + S::TC * q;
      float v[3] = {0.f, 0.f, 0.f};
      if (c < a.K && i < a.nv) jt_contact<PARTS>(a, e, c, i, fr[q], g[q], v);
#pragma unroll
      for (int r = 0; r < 3; ++r) W[s][3 * q + r] = v[r];
    }
#pragma unroll
    for (int p = 0; p < S::LR; ++p) {
      const int l = S::TC - 1 - cg + S::TC * p;
      W[s][3 * S::KR + p] =
          (l < a.L && i < a.nv) ? jt_limit<PARTS>(a, e, l, i) : 0.f;
    }
  }
}

// X = L^-1 X for the C columns of X (and y = L^-1 y when WITH_Y),
// right-looking: row k = kr + TR ks lives in slot ks of row group kr; its
// owner scales it, every thread of its column group takes it by __shfl
// and updates its rows below k (the register kernel's phase 2). Ls holds
// L transposed (column k of L is row k of Ls, read at fixed offsets).
template <class S, int C, bool WITH_Y>
__device__ __forceinline__ void fwd_solve(float (&X)[S::RPT][C],
                                          float (&y)[S::RPT],
                                          const float* Ls, const float* inv_ld,
                                          int nv, int ldl, int rg, int src0) {
#pragma unroll
  for (int ks = 0; ks < S::RPT; ++ks) {
#pragma unroll 1
    for (int kr = 0; kr < S::TR; ++kr) {
      const int k = kr + S::TR * ks;
      if (k >= nv) break;
      const float sc = rg == kr ? inv_ld[k] : 1.f;
#pragma unroll
      for (int j = 0; j < C; ++j) X[ks][j] *= sc;
      float xk[C];
#pragma unroll
      for (int j = 0; j < C; ++j) xk[j] = __shfl_sync(FULL, X[ks][j], src0 + kr);
      float yk = 0.f;
      if (WITH_Y) {
        y[ks] *= sc;
        yk = __shfl_sync(FULL, y[ks], src0 + kr);
      }
#pragma unroll
      for (int s = ks; s < S::RPT; ++s) {
        const int i = rg + S::TR * s;
        const float l = (i > k && i < nv) ? Ls[k * ldl + i] : 0.f;
#pragma unroll
        for (int j = 0; j < C; ++j) X[s][j] = fmaf(-l, xk[j], X[s][j]);
        if (WITH_Y) y[s] = fmaf(-l, yk, y[s]);
      }
    }
  }
}

// Sum of RPT row partials over the TC column groups (the W v side), for
// the shared-memory plan: the 8 column groups of a warp reduce-scatter
// the rows (padded to 16: each lane keeps rows s0, s0 + 1 with s0 =
// 8 b4 + 4 b3 + 2 b2 from its lane bits), one shared-memory pass sums
// the warps' partials of those two rows, and the lanes gather the 16 back
// in the reverse order. 28 shuffles and 2 NW reads a thread, against
// rowsum's 3 RPT shuffles and NW RPT reads. p is one buffer of
// Split::PART floats.
// One level of rowsum_rs: lanes whose bit M is set keep the upper H of
// the first 2H values, the others the lower H; each adds its partner's.
template <int H, int M>
__device__ __forceinline__ void scatter_level(float (&v)[16], int lane) {
  const bool hi = lane & M;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = hi ? v[i] : v[i + H];
    const float keep = hi ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, M);
  }
}

// The reverse: H values become 2H, the partner's half beside one's own.
template <int H, int M>
__device__ __forceinline__ void gather_level(float (&v)[16], int lane) {
  const bool hi = lane & M;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float o = __shfl_xor_sync(FULL, v[i], M);
    v[i + H] = hi ? v[i] : o;
    v[i] = hi ? o : v[i];
  }
}

template <class S>
__device__ __forceinline__ void rowsum_rs(float (&u)[S::RPT], float* p,
                                          int tid) {
  static_assert(S::TR == 4 && S::RPT <= 16, "rowsum_rs: 4 row groups");
  constexpr int NW = S::T / 32;
  const int lane = tid & 31, rg = lane & 3;
  float v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = i < S::RPT ? u[i] : 0.f;
  scatter_level<8, 16>(v, lane);
  scatter_level<4, 8>(v, lane);
  scatter_level<2, 4>(v, lane);
  const int s0 = (lane >> 4 & 1) * 8 + (lane >> 3 & 1) * 4 + (lane >> 2 & 1) * 2;
  float* q = p + rg * 16 + s0;
  q[(tid >> 5) * S::TR * 16] = v[0];
  q[(tid >> 5) * S::TR * 16 + 1] = v[1];
  __syncthreads();
  v[0] = v[1] = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    v[0] += q[w * S::TR * 16];
    v[1] += q[w * S::TR * 16 + 1];
  }
  gather_level<2, 4>(v, lane);
  gather_level<4, 8>(v, lane);
  gather_level<8, 16>(v, lane);
#pragma unroll
  for (int s = 0; s < S::RPT; ++s) u[s] = v[s];
}

// The shared part of u = W v: u[s] += sum over the thread's shared
// columns of W[s][j] v[j], v[j] = vs[j T] (in the power iteration
// vs[j T] / dn * active).
template <class S, bool POWER>
__device__ __forceinline__ void wv_shared(const float* Ws, const float* vs,
                                          const float4* cvs, int SC, float dn,
                                          float (&u)[S::RPT]) {
#pragma unroll 4
  for (int j = 0; j < SC; ++j) {
    float v = vs[j * S::T];
    if (POWER) v = __fdividef(v, dn) * cvs[j * S::TC].w;
    const float* w = Ws + j * S::RPT * S::T;
#pragma unroll
    for (int s = 0; s < S::RPT; ++s) u[s] = fmaf(w[s * S::T], v, u[s]);
  }
}

// g[c] = (W^T u) over the env of the C shared columns j0 + c; a column
// past jn reads column 0 instead (its g is not used). Each column sums its
// rows in two chains, and the C columns' loads and sums interleave.
template <class S, int C>
__device__ __forceinline__ void wtu_shared(const float* Wt, int j0, int jn,
                                           const float (&u)[S::RPT],
                                           float (&g)[C]) {
  const float* w[C];
  float a0[C], a1[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    w[c] = Wt + (j0 + c < jn ? j0 + c : 0) * S::RPT * S::T;
    a0[c] = a1[c] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < S::RPT; s += 2)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      a0[c] = fmaf(w[c][s * S::T], u[s], a0[c]);
      if (s + 1 < S::RPT) a1[c] = fmaf(w[c][(s + 1) * S::T], u[s + 1], a1[c]);
    }
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = colsum<typename S::P>(a0[c] + a1[c]);
}

template <class S, bool PARTS, bool PYR>
__global__ void __launch_bounds__(S::T, S::MINB)
    fused_solve_shared_kernel(Args a) {
  using P = typename S::P;
  constexpr int TR = S::TR, TC = S::TC, T = S::T, RPT = S::RPT;
  constexpr int KR = S::KR, LR = S::LR, CR = S::CR;
  constexpr int MC = Smem<P>::MC, CS = Smem<P>::CS;
  extern __shared__ __align__(16) float fs_smem[];
  const int nv = a.nv, n = a.n, K = a.K, L = a.L;
  const int QS = S::qs(K), PS = S::ps(L), SC = 3 * QS + PS;
  const int ldl = nv | 1;
  float4* cv = reinterpret_cast<float4*>(fs_smem);  // column constants
  float* Ws = fs_smem + 4 * TC * (CR + SC);         // W's shared part
  float* vbuf = Ws + SC * RPT * T;                  // v, then lam
  float* mus = vbuf + SC * T;                       // mu
  float* Ls = mus + (KR + QS) * TC;                 // L^T, upper triangle
  float* inv_ld = Ls + nv * ldl;                    // 1 / L[k][k]
  float* ybuf = inv_ld + nv;                        // y = L^-1 qf
  float* tbuf = ybuf + nv;                          // t = W lam
  float* part = tbuf + nv;                          // per-warp partials
  float* colbuf = part;                     // Cholesky columns, then
  float* trash = part + 2 * CS;             //   non-owners' stores
  // the two partial buffers in turn: each reduction takes the other one
  // than the last, so one barrier a reduction suffices
  const int tid = threadIdx.x;
  int buf = 0;
  auto red = [&]() -> float* {
    buf ^= 1;
    return part + (buf ^ 1) * S::PART;
  };
  auto sum_all = [&](float v) {  // allsum over the buffer red() gives
    int b = 0;
    return allsum<P>(v, red(), b, tid);
  };
  const int rg = tid % TR, cg = tid / TR;
  const int src0 = (tid & 31) & ~(TR - 1);  // lane of row group 0
  const long long e = blockIdx.x;
  const float4* cvp = cv + cg;    // slot j at cvp[j * TC]
  const float4* cvs = cvp + CR * TC;
  float* Wt = Ws + tid;           // shared column j, row slot s at
  float* vt = vbuf + tid;         //   Wt[(j RPT + s) T]; vector at vt[j T]
  // global column of slot j of column group g: the register slots, then
  // the shared ones; -1 for a pad slot
  auto col_of = [&](int j, int g) -> int {
    int q = -1, r = 0, p = 0;
    if (j < 3 * KR) {
      q = j / 3;
      r = j % 3;
    } else if (j < CR) {
      p = j - 3 * KR;
    } else if (j < CR + 3 * QS) {
      q = KR + (j - CR) / 3;
      r = (j - CR) % 3;
    } else {
      p = LR + j - CR - 3 * QS;
    }
    if (q >= 0) {
      const int c = g + TC * q;
      return c < K ? r * K + c : -1;
    }
    const int l = TC - 1 - g + TC * p;
    return l < L ? 3 * K + l : -1;
  };
  STAMP(0);

  // ---- 0. load: M into registers (as the register kernel), J of the
  // shared columns into the thread's slots, mu, qf -------------------------
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
#pragma unroll 2
  for (int q = 0; q < QS; ++q) {
    const int c = cg + TC * (KR + q);
    store_contact<S, PARTS>(a, e, c, rg, Wt + 3 * q * RPT * T);
    if (rg == 0) mus[(KR + q) * TC + cg] = c < K ? a.mu[e * K + c] : 0.f;
  }
#pragma unroll 1
  for (int p = 0; p < PS; ++p)
    store_limit<S, PARTS>(a, e, TC - 1 - cg + TC * (LR + p), rg,
                          Wt + (3 * QS + p) * RPT * T);
#pragma unroll
  for (int q = 0; q < KR; ++q) {
    const int c = cg + TC * q;
    if (rg == 0) mus[q * TC + cg] = c < K ? a.mu[e * K + c] : 0.f;
  }
  STAMP(1);

  // ---- 1. Cholesky, right-looking, in registers (the register kernel's
  // phase 1) ---------------------------------------------------------------
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
      __syncthreads();
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
  __syncthreads();
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int i = rg + TR * s;
#pragma unroll
    for (int t = 0; t < MC; ++t) {
      const int k = cg + TC * t;
      if (k <= i && i < nv) Ls[k * ldl + i] = A[s][t] * inv_ld[k];
    }
  }
  __syncthreads();
  STAMP(2);

  // ---- 2. W = L^-1 J^T and y = L^-1 qf, right-looking: the shared
  // columns CR at a time through the W tile's registers, then the
  // register columns (read or built from the parts here) with y ----------
  float W[RPT][CR], y[RPT];
#pragma unroll 1
  for (int j0 = 0; j0 < SC; j0 += CR) {
#pragma unroll
    for (int s = 0; s < RPT; ++s)
#pragma unroll
      for (int j = 0; j < CR; ++j)
        W[s][j] = j0 + j < SC ? Wt[((j0 + j) * RPT + s) * T] : 0.f;
    fwd_solve<S, CR, false>(W, y, Ls, inv_ld, nv, ldl, rg, src0);
#pragma unroll
    for (int s = 0; s < RPT; ++s)
#pragma unroll
      for (int j = 0; j < CR; ++j)
        if (j0 + j < SC) Wt[((j0 + j) * RPT + s) * T] = W[s][j];
  }
  load_registers<S, PARTS>(a, e, cg, rg, W);
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int i = rg + TR * s;
    y[s] = i < nv ? a.qf[e * nv + i] : 0.f;
  }
  fwd_solve<S, CR, true>(W, y, Ls, inv_ld, nv, ldl, rg, src0);
  if (cg == 0) {
#pragma unroll
    for (int s = 0; s < RPT; ++s)
      if (rg + TR * s < nv) ybuf[rg + TR * s] = y[s];
  }
  STAMP(3);

  // ---- 3. diagA, R, inverse diagonal, b: the column constants ----------
  // Each column group's sums over its rows go to its slots first; then
  // every thread takes (slot, column group) pairs in turn, so the reads
  // of imp, aref and active are shared out and coalesced.
#pragma unroll
  for (int j = 0; j < CR; ++j) {
    float sw = 0.f, sb = 0.f;
#pragma unroll
    for (int s = 0; s < RPT; ++s) {
      sw = fmaf(W[s][j], W[s][j], sw);
      sb = fmaf(W[s][j], y[s], sb);
    }
    sw = colsum<P>(sw);
    sb = colsum<P>(sb);
    if (rg == 0) cv[j * TC + cg] = make_float4(sw, sb, 0.f, 0.f);
  }
#pragma unroll 1
  for (int j = 0; j < SC; ++j) {
    float sw = 0.f, sb = 0.f;
#pragma unroll
    for (int s = 0; s < RPT; ++s) {
      const float w = Wt[(j * RPT + s) * T];
      sw = fmaf(w, w, sw);
      sb = fmaf(w, y[s], sb);
    }
    sw = colsum<P>(sw);
    sb = colsum<P>(sb);
    if (rg == 0) cv[(CR + j) * TC + cg] = make_float4(sw, sb, 0.f, 0.f);
  }
  __syncthreads();
#pragma unroll 2
  for (int idx = tid; idx < (CR + SC) * TC; idx += T) {
    const int c = col_of(idx / TC, idx % TC);
    const size_t o = e * n + c;
    const float4 sums = cv[idx];
    const float diagA = fmaxf(sums.x, 1e-8f);
    const float im = c >= 0 ? fminf(fmaxf(a.imp[o], 1e-5f), 1.f - 1e-5f) : 0.5f;
    const float r = (1.f - im) / im * diagA;
    cv[idx] = make_float4(r, 1.f / fmaxf(diagA + r, 1e-8f),
                          sums.y - (c >= 0 ? a.aref[o] : 0.f),
                          c >= 0 ? a.active[o] : 0.f);
  }
  __syncthreads();
  STAMP(4);

  // ---- 4. power iteration for the step size -----------------------------
  // The shared columns keep vec unnormalised in their slots, divided by
  // the last norm dn when read (the register kernel divides at once).
  float vec[CR], v[CR], u[RPT];
  float dn;
  {
    float s2 = 0.f;
#pragma unroll
    for (int j = 0; j < CR; ++j) {
      vec[j] = cvp[j * TC].w;
      s2 = fmaf(vec[j], vec[j], s2);
    }
#pragma unroll 1
    for (int j = 0; j < SC; ++j) {
      const float act = cvs[j * TC].w;
      vt[j * T] = act;
      s2 = fmaf(act, act, s2);
    }
    dn = fmaxf(fsqrt(sum_all(s2)), 1e-12f);
#pragma unroll
    for (int j = 0; j < CR; ++j) vec[j] = __fdividef(vec[j], dn);
  }
  float lam_max = 1.f;
#pragma unroll 1
  for (int it = 0; it <= POWER_ITERS; ++it) {
#pragma unroll
    for (int j = 0; j < CR; ++j) v[j] = vec[j] * cvp[j * TC].w;
#pragma unroll
    for (int s = 0; s < RPT; ++s) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < CR; ++j) acc = fmaf(W[s][j], v[j], acc);
      u[s] = acc;
    }
    wv_shared<S, true>(Wt, vt, cvs, SC, dn, u);
    rowsum_rs<S>(u, red(), tid);
    float s2 = 0.f;
#pragma unroll
    for (int j = 0; j < CR; ++j) {
      const float4 c = cvp[j * TC];
      const float g = wtu<P>(W, u, j) + c.x * v[j];
      vec[j] = c.y * g * c.w;
      s2 = fmaf(vec[j], vec[j], s2);
    }
#pragma unroll 1
    for (int j0 = 0; j0 < SC; j0 += 3) {
      float g[3], vj[3];
      float4 c[3];
      wtu_shared<S, 3>(Wt, j0, SC, u, g);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int j = j0 + q < SC ? j0 + q : 0;
        c[q] = cvs[j * TC];
        vj[q] = __fdividef(vt[j * T], dn) * c[q].w;
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float vn = c[q].y * (g[q] + c[q].x * vj[q]) * c[q].w;
        if (j0 + q < SC) {
          vt[(j0 + q) * T] = vn;
          s2 = fmaf(vn, vn, s2);
        }
      }
    }
    // the last pass only reads the norm: lam_max keeps its value
    const float nrm = fsqrt(sum_all(s2));
    dn = fmaxf(nrm, 1e-12f);
#pragma unroll
    for (int j = 0; j < CR; ++j) vec[j] = __fdividef(vec[j], dn);
    lam_max = fmaxf(nrm, 1.f);
  }
  const float step = fminf(1.5f / lam_max, 1.f);
  STAMP(5);

  // ---- 5. projected sweeps from project(lam0) ---------------------------
  float lam[CR];
  {
    float ac[CR];
#pragma unroll
    for (int j = 0; j < CR; ++j) {
      const int c = col_of(j, cg);
      lam[j] = c >= 0 ? a.lam0[e * n + c] : 0.f;
      ac[j] = cvp[j * TC].w;
    }
    float mu[KR];
#pragma unroll
    for (int q = 0; q < KR; ++q) mu[q] = mus[q * TC + cg];
    project<P, PYR>(lam, ac, mu, lam);
  }
#pragma unroll 1
  for (int q = 0; q < QS; ++q) {
    float l0[3], ac[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int c = col_of(CR + 3 * q + r, cg);
      l0[r] = c >= 0 ? a.lam0[e * n + c] : 0.f;
      ac[r] = cvs[(3 * q + r) * TC].w;
    }
    cone<PYR>(l0[0], l0[1], l0[2], mus[(KR + q) * TC + cg], ac[0], ac[1], ac[2],
              vt[3 * q * T], vt[(3 * q + 1) * T], vt[(3 * q + 2) * T]);
  }
#pragma unroll 1
  for (int p = 0; p < PS; ++p) {
    const int j = 3 * QS + p, c = col_of(CR + j, cg);
    vt[j * T] = fmaxf(c >= 0 ? a.lam0[e * n + c] : 0.f, 0.f) *
                cvs[j * TC].w;
  }
#pragma unroll 1
  for (int it = 0; it < a.iterations; ++it) {
#pragma unroll
    for (int s = 0; s < RPT; ++s) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < CR; ++j) acc = fmaf(W[s][j], lam[j], acc);
      u[s] = acc;
    }
    wv_shared<S, false>(Wt, vt, cvs, SC, 1.f, u);
    rowsum_rs<S>(u, red(), tid);
    {
      float x[CR], ac[CR];
#pragma unroll
      for (int j = 0; j < CR; ++j) {
        const float4 c = cvp[j * TC];
        const float g = wtu<P>(W, u, j) + c.x * lam[j];
        x[j] = lam[j] - step * c.y * (g + c.z);
        ac[j] = c.w;
      }
      float mu[KR];
#pragma unroll
      for (int q = 0; q < KR; ++q) mu[q] = mus[q * TC + cg];
      project<P, PYR>(x, ac, mu, lam);
    }
    // the shared contacts two at a time (the second a pad when QS is
    // odd), then the shared limit rows two at a time
#pragma unroll 1
    for (int q = 0; q < QS; q += 2) {
      float g[6], x[6], ac[6];
      wtu_shared<S, 6>(Wt, 3 * q, 3 * QS, u, g);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const int j = 3 * q + k < 3 * QS ? 3 * q + k : 0;
        const float4 c = cvs[j * TC];
        const float lj = vt[j * T];
        const float gk = g[k] + c.x * lj;
        x[k] = lj - step * c.y * (gk + c.z);
        ac[k] = c.w;
      }
      cone<PYR>(x[0], x[1], x[2], mus[(KR + q) * TC + cg], ac[0], ac[1], ac[2],
                vt[3 * q * T], vt[(3 * q + 1) * T], vt[(3 * q + 2) * T]);
      if (q + 1 < QS)
        cone<PYR>(x[3], x[4], x[5], mus[(KR + q + 1) * TC + cg], ac[3], ac[4],
                  ac[5], vt[(3 * q + 3) * T], vt[(3 * q + 4) * T],
                  vt[(3 * q + 5) * T]);
    }
#pragma unroll 1
    for (int p = 0; p < PS; p += 2) {
      float g[2], x[2];
      wtu_shared<S, 2>(Wt, 3 * QS + p, SC, u, g);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int j = 3 * QS + p + k < SC ? 3 * QS + p + k : 0;
        const float4 c = cvs[j * TC];
        const float lj = vt[j * T];
        const float gk = g[k] + c.x * lj;
        x[k] = fmaxf(lj - step * c.y * (gk + c.z), 0.f) * c.w;
      }
      vt[(3 * QS + p) * T] = x[0];
      if (p + 1 < PS) vt[(3 * QS + p + 1) * T] = x[1];
    }
  }
  STAMP(6);

  // ---- 6. outputs (the register kernel's phase 6) ------------------------
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < CR; ++j) acc = fmaf(W[s][j], lam[j], acc);
    u[s] = acc;
  }
  wv_shared<S, false>(Wt, vt, cvs, SC, 1.f, u);
  rowsum_rs<S>(u, red(), tid);  // t = W lam; cv is free from here
  if (cg == 0) {
#pragma unroll
    for (int s = 0; s < RPT; ++s)
      if (rg + TR * s < nv) tbuf[rg + TR * s] = u[s];
  }
  if (rg == 0) {
#pragma unroll
    for (int j = 0; j < CR; ++j) cv[j * TC + cg].x = lam[j];
  }
  __syncthreads();
  // lam: (slot, column group) pairs shared out as in phase 3
#pragma unroll 2
  for (int idx = tid; idx < (CR + SC) * TC; idx += T) {
    const int j = idx / TC, g = idx % TC, c = col_of(j, g);
    if (c >= 0)
      a.lam[e * n + c] = j < CR ? cv[idx].x : vbuf[(j - CR) * T + g * TR];
  }
  // qfrc = L t = J^T lam: column group cg takes k = cg, cg + TC, ...
  float z[RPT];
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int i = rg + TR * s;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < MC; ++t) {
      const int k = min(cg + TC * t, nv - 1);
      acc += (k == cg + TC * t && k <= i && i < nv)
                 ? Ls[k * ldl + min(i, nv - 1)] * tbuf[k]
                 : 0.f;
    }
    z[s] = acc;
  }
  {
    int b = 0;
    rowsum<P>(z, red(), b, tid);
  }
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
          const float l = i < k ? Ls[i * ldl + k] : 0.f;
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

template <class S>
static const void* shared_kernel_of(bool parts, bool pyr) {
  if (parts)
    return pyr ? (const void*)fused_solve_shared_kernel<S, true, true>
               : (const void*)fused_solve_shared_kernel<S, true, false>;
  return pyr ? (const void*)fused_solve_shared_kernel<S, false, true>
             : (const void*)fused_solve_shared_kernel<S, false, false>;
}

template <class S>
static int launch_shared(const Args& a, int B, bool parts,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float) * S::floats(a.nv, a.K, a.L);
  if (a.nv > S::TR * S::RPT || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const bool pyr = a.pyramidal != 0;
  const void* kern = shared_kernel_of<S>(parts, pyr);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (parts && pyr)
    fused_solve_shared_kernel<S, true, true><<<B, S::T, smem, stream>>>(a);
  else if (parts)
    fused_solve_shared_kernel<S, true, false><<<B, S::T, smem, stream>>>(a);
  else if (pyr)
    fused_solve_shared_kernel<S, false, true><<<B, S::T, smem, stream>>>(a);
  else
    fused_solve_shared_kernel<S, false, false><<<B, S::T, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The source is built as FS_SHARDS translation units (nvcc -c, one
// process each, all started together; ops/fused_solve.py:build_all links
// them into one library): unit FS_SHARD instantiates the plans whose
// index is FS_SHARD modulo FS_SHARDS, and unit 0 also holds the C entry
// points, which ask each unit in turn. A plain build of the file (no
// FS_SHARDS) is one unit with every plan.
#ifndef FS_SHARDS
#define FS_SHARDS 1
#define FS_SHARD 0
#endif
#define FS_NOT_HERE (-1)
#define FS_CAT_(a, b) a##b
#define FS_CAT(a, b) FS_CAT_(a, b)

// plan = {tr, tc, rpt, kc, lc, shared}: a register plan of
// FUSED_SOLVE_PLANS, or with shared a plan (4, 32, RPT, KR, LR) of
// FUSED_SOLVE_SHARED
template <int I, class P>
static int launch_in_unit(const int* plan, const Args& a, int B, bool parts,
                          cudaStream_t st) {
  if constexpr (I % FS_SHARDS == FS_SHARD) {
    if (!plan[5] && plan_is<P>(plan[0], plan[1], plan[2], plan[3], plan[4]))
      return launch<P>(a, B, parts, st);
  }
  return FS_NOT_HERE;
}

template <int I, class S>
static int launch_shared_in_unit(const int* plan, const Args& a, int B,
                                 bool parts, cudaStream_t st) {
  if constexpr (I % FS_SHARDS == FS_SHARD) {
    if (plan[5] &&
        plan_is<typename S::P>(plan[0], plan[1], plan[2], plan[3], plan[4]))
      return launch_shared<S>(a, B, parts, st);
  }
  return FS_NOT_HERE;
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

template <int I, class P>
static int info_in_unit(const int* plan, bool parts, int nv, int n, int* out) {
  if constexpr (I % FS_SHARDS == FS_SHARD) {
    if (!plan[5] && plan_is<P>(plan[0], plan[1], plan[2], plan[3], plan[4]))
      return kernel_report(kernel_of<P>(parts, false), P::T,
                           (int)sizeof(float) * Smem<P>::floats(nv, n), out);
  }
  return FS_NOT_HERE;
}

template <int I, class S>
static int info_shared_in_unit(const int* plan, bool parts, int nv, int n,
                               int K, int* out) {
  if constexpr (I % FS_SHARDS == FS_SHARD) {
    if (plan[5] &&
        plan_is<typename S::P>(plan[0], plan[1], plan[2], plan[3], plan[4]))
      return kernel_report(shared_kernel_of<S>(parts, false), S::T,
                           (int)sizeof(float) * S::floats(nv, K, n - 3 * K),
                           out);
  }
  return FS_NOT_HERE;
}

// This unit's plans: FS_NOT_HERE when none of them is plan.
extern "C" int FS_CAT(fused_solve_unit_launch, FS_SHARD)(
    const int* plan, const Args* a, int B, int parts, void* stream) {
  int r;
  cudaStream_t st = (cudaStream_t)stream;
#define FS_DISPATCH(i_, tr_, tc_, rpt_, kc_, lc_)                           \
  if ((r = launch_in_unit<i_, Plan<tr_, tc_, rpt_, kc_, lc_>>(plan, *a, B, \
                                                             parts, st)) != \
      FS_NOT_HERE)                                                         \
    return r;
  FUSED_SOLVE_PLANS(FS_DISPATCH)
#undef FS_DISPATCH
#define FS_DISPATCH_SHARED(i_, tc_, rpt_, kr_, lr_, mb_)                  \
  if ((r = launch_shared_in_unit<i_, Split<tc_, rpt_, kr_, lr_, mb_>>(    \
           plan, *a, B, parts, st)) != FS_NOT_HERE)                       \
    return r;
  FUSED_SOLVE_SHARED(FS_DISPATCH_SHARED)
#undef FS_DISPATCH_SHARED
  return FS_NOT_HERE;
}

extern "C" int FS_CAT(fused_solve_unit_info, FS_SHARD)(
    const int* plan, int parts, int nv, int n, int K, int* out) {
  int r;
#define FS_INFO(i_, tr_, tc_, rpt_, kc_, lc_)                              \
  if ((r = info_in_unit<i_, Plan<tr_, tc_, rpt_, kc_, lc_>>(              \
           plan, parts != 0, nv, n, out)) != FS_NOT_HERE)                 \
    return r;
  FUSED_SOLVE_PLANS(FS_INFO)
#undef FS_INFO
#define FS_INFO_SHARED(i_, tc_, rpt_, kr_, lr_, mb_)                      \
  if ((r = info_shared_in_unit<i_, Split<tc_, rpt_, kr_, lr_, mb_>>(      \
           plan, parts != 0, nv, n, K, out)) != FS_NOT_HERE)              \
    return r;
  FUSED_SOLVE_SHARED(FS_INFO_SHARED)
#undef FS_INFO_SHARED
  return FS_NOT_HERE;
}

#if FS_SHARD == 0
#define FS_UNIT_DECL(i)                                                    \
  extern "C" int fused_solve_unit_launch##i(const int*, const Args*, int,  \
                                            int, void*);                   \
  extern "C" int fused_solve_unit_info##i(const int*, int, int, int, int,  \
                                          int*);
#if FS_SHARDS > 1
FS_UNIT_DECL(1)
#endif
#if FS_SHARDS > 2
FS_UNIT_DECL(2)
#endif
#if FS_SHARDS > 3
FS_UNIT_DECL(3)
#endif
static_assert(FS_SHARDS >= 1 && FS_SHARDS <= 4, "1 to 4 units");
typedef int (*UnitLaunch)(const int*, const Args*, int, int, void*);
typedef int (*UnitInfo)(const int*, int, int, int, int, int*);
static const UnitLaunch unit_launch[FS_SHARDS] = {
    fused_solve_unit_launch0,
#if FS_SHARDS > 1
    fused_solve_unit_launch1,
#endif
#if FS_SHARDS > 2
    fused_solve_unit_launch2,
#endif
#if FS_SHARDS > 3
    fused_solve_unit_launch3,
#endif
};
static const UnitInfo unit_info[FS_SHARDS] = {
    fused_solve_unit_info0,
#if FS_SHARDS > 1
    fused_solve_unit_info1,
#endif
#if FS_SHARDS > 2
    fused_solve_unit_info2,
#endif
#if FS_SHARDS > 3
    fused_solve_unit_info3,
#endif
};

// One launch of B envs. JT == NULL selects the parts path (cd_lin ...
// ld_idx); otherwise the parts pointers are ignored. clocks is read only
// by the -DFUSED_SOLVE_CLOCKS build. (tr, tc, rpt, kc, lc) is one of
// FUSED_SOLVE_PLANS, within the register plans' range, or with shared
// (4, 32, RPT, KR, LR) of one of FUSED_SOLVE_SHARED, within one block's
// shared memory.
extern "C" int fused_solve_launch(
    const void* M, const void* JT, const void* cd_lin, const void* cd_ang,
    const void* frame, const void* rpos, const void* w, const void* sign_l,
    const void* ld_idx, const void* qf, const void* aref, const void* imp,
    const void* active, const void* mu, const void* lam0, void* qacc,
    void* qfrc, void* lam, void* clocks, int B, int nv, int n, int K, int L,
    int iterations, int pyramidal, int tr, int tc, int rpt, int kc, int lc,
    int shared, void* stream) {
  if (nv < 1 || n != 3 * K + L || K < 0 || L < 0 || B < 0 || iterations < 0)
    return (int)cudaErrorInvalidValue;
  if (!shared && (nv > REG_NV_MAX || n > REG_N_MAX || K > REG_K_MAX))
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
  const int plan[6] = {tr, tc, rpt, kc, lc, shared};
  for (int u = 0; u < FS_SHARDS; ++u) {
    const int r = unit_launch[u](plan, &a, B, JT == nullptr, stream);
    if (r != FS_NOT_HERE) return r;
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int fused_solve_info(int tr, int tc, int rpt, int kc, int lc,
                                int shared, int parts, int nv, int n, int K,
                                int* out) {
  const int plan[6] = {tr, tc, rpt, kc, lc, shared};
  for (int u = 0; u < FS_SHARDS; ++u) {
    const int r = unit_info[u](plan, parts, nv, n, K, out);
    if (r != FS_NOT_HERE) return r;
  }
  return (int)cudaErrorInvalidValue;
}
#endif  // FS_SHARD == 0
