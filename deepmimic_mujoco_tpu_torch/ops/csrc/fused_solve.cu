// Fused mass-matrix solve + constraint solve, one thread block per env.
//
// Replaces the TPU kernel deepmimic_mujoco_tpu/ops/fused_solve.py:
// _fused_kernel (a Pallas kernel that holds 128 envs in the lanes of one
// grid program). Per env, in fp32, it computes what that kernel computes:
//   1. Cholesky M = L L^T (right-looking, in place in shared memory)
//   2. W = L^-1 J^T, and y = L^-1 qf
//   3. diagA = sum_i W_i^2, R = (1-imp)/imp diagA, b = W^T y - aref
//   4. 12 power iterations on the active rows -> step = min(1.5/lmax, 1)
//   5. `iterations` projected diagonal-scaled gradient sweeps from
//      project(lam0), Ahat v = W^T (W v) + R v, elliptic cone (or the L1
//      diamond when `pyramidal`), limit rows >= 0, all masked by active
//   6. qacc = L^-T (y + W lam), qfrc = L (W lam), lam.
// The step rule, the clamps, the projection and the warm start copy
// physics/solver.py:_pgs_iterate of the JAX package exactly.
//
// What bounds it on the H100: ~0.78 MFLOP per env at humanoid3d size
// (nv 34, n 76) against ~17 KB of input and output, so the arithmetic
// sets the bound (ops/fused_solve.py:bound_ms). The design keeps an env's
// whole working set (M/L, W and the vectors: ~22 KB at humanoid3d, ~37 KB
// at G1) in one block's static shared memory, sized for nv <= 48 and
// n <= 112, so only inputs and outputs touch device memory. Rows of
// M and W use odd strides, so walks along a row (threads over columns)
// and down a column (threads over rows) are both free of bank conflicts.
// Reductions over the block use a shared-memory tree.
#include <cuda_runtime.h>

#define NV_MAX 48
#define N_MAX 112
#define K_MAX 37
#define LDM (NV_MAX + 1)
#define LDW (N_MAX + 1)
#define THREADS 128
#define POWER_ITERS 12

__device__ __forceinline__ float block_sum(float v, float* red, int tid) {
  red[tid] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  float r = red[0];
  __syncthreads();
  return r;
}

// Returns (W^T (W v) + R v)[tid] for tid < n (0 otherwise). `u` receives
// W v. Callers synchronise before `u` or `v` are written again.
__device__ __forceinline__ float matvec(const float* Ws, const float* v,
                                        const float* R, float* u, int nv,
                                        int n, int tid) {
  if (tid < nv) {
    const float* row = Ws + tid * LDW;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    int c = 0;
    for (; c + 3 < n; c += 4) {
      s0 += row[c] * v[c];
      s1 += row[c + 1] * v[c + 1];
      s2 += row[c + 2] * v[c + 2];
      s3 += row[c + 3] * v[c + 3];
    }
    for (; c < n; ++c) s0 += row[c] * v[c];
    u[tid] = (s0 + s1) + (s2 + s3);
  }
  __syncthreads();
  float r = 0.f;
  if (tid < n) {
    for (int i = 0; i < nv; ++i) r += Ws[i * LDW + tid] * u[i];
    r += R[tid] * v[tid];
  }
  return r;
}

// dst = project(src) * active. Contact c (tid < K) owns rows c, K+c, 2K+c.
__device__ __forceinline__ void project(const float* src, float* dst,
                                        const float* act, const float* mus,
                                        int n, int K, int pyramidal,
                                        int tid) {
  if (tid < K) {
    float nrm = fmaxf(src[tid], 0.f);
    float t1 = src[K + tid];
    float t2 = src[2 * K + tid];
    float lim = mus[tid] * nrm;
    float t1s, t2s;
    if (pyramidal) {
      float a1 = fabsf(t1), a2 = fabsf(t2);
      float x = fminf(fmaxf((a1 - a2 + lim) * 0.5f, 0.f), lim);
      bool over = a1 + a2 > lim;
      float p1 = over ? x : a1;
      float p2 = over ? lim - x : a2;
      t1s = (t1 > 0.f ? p1 : (t1 < 0.f ? -p1 : 0.f));
      t2s = (t2 > 0.f ? p2 : (t2 < 0.f ? -p2 : 0.f));
    } else {
      float tn = sqrtf(t1 * t1 + t2 * t2 + 1e-24f);
      float scale = tn > lim ? lim / tn : 1.f;
      t1s = t1 * scale;
      t2s = t2 * scale;
    }
    dst[tid] = nrm * act[tid];
    dst[K + tid] = t1s * act[K + tid];
    dst[2 * K + tid] = t2s * act[2 * K + tid];
  } else if (tid >= 3 * K && tid < n) {
    dst[tid] = fmaxf(src[tid], 0.f) * act[tid];
  }
}

__global__ void __launch_bounds__(THREADS) fused_solve_kernel(
    const float* __restrict__ M, const float* __restrict__ JT,
    const float* __restrict__ qf, const float* __restrict__ aref,
    const float* __restrict__ imp, const float* __restrict__ active,
    const float* __restrict__ mu, const float* __restrict__ lam0,
    float* __restrict__ qacc, float* __restrict__ qfrc,
    float* __restrict__ lam_out, int nv, int n, int K, int iterations,
    int pyramidal) {
  __shared__ float Ls[NV_MAX * LDM];  // M, then L in the lower triangle
  __shared__ float Ws[NV_MAX * LDW];  // J^T, then W = L^-1 J^T
  __shared__ float inv_ld[NV_MAX];    // 1 / L[k][k]
  __shared__ float y[NV_MAX];         // L^-1 qf
  __shared__ float u[NV_MAX];         // W v
  __shared__ float R[N_MAX], invd[N_MAX], b[N_MAX], act[N_MAX];
  __shared__ float lam[N_MAX], x[N_MAX], vec[N_MAX];
  __shared__ float mus[K_MAX];
  __shared__ float red[THREADS];

  const int tid = threadIdx.x;
  const size_t e = blockIdx.x;
  const float* Me = M + e * nv * nv;
  const float* Je = JT + e * nv * n;

  // ---- 0. load ---------------------------------------------------------
  for (int i = tid; i < nv * nv; i += THREADS)
    Ls[(i / nv) * LDM + i % nv] = Me[i];
  for (int i = tid; i < nv * n; i += THREADS)
    Ws[(i / n) * LDW + i % n] = Je[i];
  if (tid < n) {
    act[tid] = active[e * n + tid];
    x[tid] = lam0[e * n + tid];
  }
  if (tid < K) mus[tid] = mu[e * K + tid];
  __syncthreads();

  // ---- 1. Cholesky, right-looking, one column per phase ---------------
  // Phase j reads the pivot and column j unscaled and updates the
  // trailing lower triangle; column j is scaled in phase j+1, which
  // reads no entry of it.
  for (int j = 0; j < nv; ++j) {
    float d = rsqrtf(fmaxf(Ls[j * LDM + j], 1e-12f));
    if (j > 0) {
      float dp = inv_ld[j - 1];
      for (int i = j - 1 + tid; i < nv; i += THREADS)
        Ls[i * LDM + j - 1] *= dp;
    }
    if (tid == 0) inv_ld[j] = d;
    int m = nv - j - 1;
    for (int idx = tid; idx < m * m; idx += THREADS) {
      int i = j + 1 + idx / m, k = j + 1 + idx % m;
      if (k <= i)
        Ls[i * LDM + k] -= (Ls[i * LDM + j] * d) * (Ls[k * LDM + j] * d);
    }
    __syncthreads();
  }
  {
    float dp = inv_ld[nv - 1];
    if (tid == 0) Ls[(nv - 1) * LDM + nv - 1] *= dp;
  }
  __syncthreads();

  // ---- 2. W = L^-1 J^T (thread per column), y = L^-1 qf (thread n) ----
  if (tid < n) {
    for (int i = 0; i < nv; ++i) {
      float s = Ws[i * LDW + tid];
      for (int k = 0; k < i; ++k) s -= Ls[i * LDM + k] * Ws[k * LDW + tid];
      Ws[i * LDW + tid] = s * inv_ld[i];
    }
  } else if (tid == n) {
    for (int i = 0; i < nv; ++i) {
      float s = qf[e * nv + i];
      for (int k = 0; k < i; ++k) s -= Ls[i * LDM + k] * y[k];
      y[i] = s * inv_ld[i];
    }
  }
  __syncthreads();

  // ---- 3. diagA, R, inverse diagonal, b --------------------------------
  float a_t = 0.f;
  if (tid < n) {
    float sw = 0.f, sb = 0.f;
    for (int i = 0; i < nv; ++i) {
      float w = Ws[i * LDW + tid];
      sw += w * w;
      sb += w * y[i];
    }
    float diagA = fmaxf(sw, 1e-8f);
    float im = fminf(fmaxf(imp[e * n + tid], 1e-5f), 1.f - 1e-5f);
    float r = (1.f - im) / im * diagA;
    R[tid] = r;
    invd[tid] = 1.f / fmaxf(diagA + r, 1e-8f);
    b[tid] = sb - aref[e * n + tid];
    a_t = act[tid];
  }

  // ---- 4. power iteration for the step size -----------------------------
  float anrm = sqrtf(block_sum(a_t * a_t, red, tid));
  if (tid < n) vec[tid] = a_t / fmaxf(anrm, 1e-12f);
  float lam_max = 1.f;
  for (int it = 0; it <= POWER_ITERS; ++it) {
    if (tid < n) lam[tid] = vec[tid] * act[tid];
    __syncthreads();
    float w = matvec(Ws, lam, R, u, nv, n, tid);
    w = tid < n ? invd[tid] * w * act[tid] : 0.f;
    float nrm = sqrtf(block_sum(w * w, red, tid));
    if (it < POWER_ITERS) {
      if (tid < n) vec[tid] = w / fmaxf(nrm, 1e-12f);
    } else {
      lam_max = fmaxf(nrm, 1.f);
    }
  }
  const float step = fminf(1.5f / lam_max, 1.f);

  // ---- 5. projected sweeps from project(lam0) ---------------------------
  project(x, lam, act, mus, n, K, pyramidal, tid);
  __syncthreads();
  for (int it = 0; it < iterations; ++it) {
    float g = matvec(Ws, lam, R, u, nv, n, tid);
    if (tid < n) x[tid] = lam[tid] - step * invd[tid] * (g + b[tid]);
    __syncthreads();
    project(x, lam, act, mus, n, K, pyramidal, tid);
    __syncthreads();
  }

  // ---- 6. outputs ---------------------------------------------------------
  if (tid < nv) {  // t = W lam
    const float* row = Ws + tid * LDW;
    float s = 0.f;
    for (int c = 0; c < n; ++c) s += row[c] * lam[c];
    u[tid] = s;
  }
  __syncthreads();
  if (tid < nv) {  // qfrc = L t = J^T lam
    float s = 0.f;
    for (int k = 0; k <= tid; ++k) s += Ls[tid * LDM + k] * u[k];
    qfrc[e * nv + tid] = s;
  } else if (tid == THREADS - 1) {  // qacc = L^-T (y + t)
    for (int k = nv - 1; k >= 0; --k) {
      float s = y[k] + u[k];
      for (int i = k + 1; i < nv; ++i) s -= Ls[i * LDM + k] * x[i];
      x[k] = s * inv_ld[k];
      qacc[e * nv + k] = x[k];
    }
  }
  if (tid < n) lam_out[e * n + tid] = lam[tid];
}

extern "C" int fused_solve_launch(
    const void* M, const void* JT, const void* qf, const void* aref,
    const void* imp, const void* active, const void* mu, const void* lam0,
    void* qacc, void* qfrc, void* lam, int B, int nv, int n, int K, int L,
    int iterations, int pyramidal, void* stream) {
  if (nv < 1 || nv > NV_MAX || n > N_MAX || n != 3 * K + L || K > K_MAX ||
      B < 0 || iterations < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  fused_solve_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)M, (const float*)JT, (const float*)qf,
      (const float*)aref, (const float*)imp, (const float*)active,
      (const float*)mu, (const float*)lam0, (float*)qacc, (float*)qfrc,
      (float*)lam, nv, n, K, iterations, pyramidal);
  return (int)cudaGetLastError();
}
