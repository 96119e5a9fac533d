// Device helpers shared by the SEPAIHRD kernels: K1 (sepaihrd_fused.cu) and
// K2/K3 (sepaihrd_adjoint.cu).
//
// Thread mapping of all three kernels: one thread per (chain, age) in groups
// of four lanes (age = tid & 3, chain = tid >> 2). A chain's 10 carried
// compartments S E P A I H ICU D CumH CumICU live in registers (R is
// absorbing, unread and unobserved, so it is not carried); the 4x4 contact
// matvec is four __shfl_sync reads inside the lane group and the sum over
// ages two __shfl_xor_sync steps. Threads past the last chain mirror the last
// chain so every shuffle has a full warp; they store nothing.

#pragma once

#include <cuda_runtime.h>

namespace sepaihrd {

constexpr int kMaxStages = 13;   // fehlberg78
constexpr int kMaxRuns = 64;
constexpr int kAges = 4;
constexpr int kCarried = 10;     // S E P A I H ICU D CumH CumICU (R dropped)
constexpr int kThreads = 128;

template <typename T>
struct Consts {
  T a[kMaxStages][kMaxStages];   // h * a_ij
  T b[kMaxStages];               // h * b_i
  T M[kAges][kAges];             // baseline contact matrix
  int run_start[kMaxRuns];
  int run_count[kMaxRuns];
};

template <typename T>
struct Lane {
  T a, hinfN, p, h, icu, dH, dICU, dcomm;            // this age
  T theta, sigma, gp, gA, gI, gH, gICU;             // this chain
  T m0, m1, m2, m3;                                 // contact row of this age
};

// Consts from the host arrays; false if a size is out of range.
template <typename T>
bool make_consts(Consts<T>& c, int n_stages, const double* a_host,
                 const double* b_host, const double* M_host, int n_runs,
                 const int* run_start, const int* run_count) {
  if (n_stages < 1 || n_stages > kMaxStages || n_runs < 1 || n_runs > kMaxRuns)
    return false;
  c = {};
  for (int i = 0; i < n_stages; ++i) {
    for (int j = 0; j < n_stages; ++j) c.a[i][j] = T(a_host[i * n_stages + j]);
    c.b[i] = T(b_host[i]);
  }
  for (int i = 0; i < kAges; ++i)
    for (int j = 0; j < kAges; ++j) c.M[i][j] = T(M_host[i * kAges + j]);
  for (int r = 0; r < n_runs; ++r) {
    c.run_start[r] = run_start[r];
    c.run_count[r] = run_count[r];
  }
  return true;
}

// this lane's parameters from agevec (8, 4, B) and scal (7, B)
template <typename T>
__device__ __forceinline__ Lane<T> load_lane(const T* __restrict__ agevec,
                                             const T* __restrict__ scal,
                                             const Consts<T>& cst, int age,
                                             int chain, int B) {
  const size_t AB = static_cast<size_t>(kAges) * B;
  const size_t at = static_cast<size_t>(age) * B + chain;
  Lane<T> q;
  q.a = agevec[0 * AB + at];
  q.hinfN = agevec[1 * AB + at];
  q.p = agevec[2 * AB + at];
  q.h = agevec[3 * AB + at];
  q.icu = agevec[4 * AB + at];
  q.dH = agevec[5 * AB + at];
  q.dICU = agevec[6 * AB + at];
  q.dcomm = agevec[7 * AB + at];
  q.theta = scal[0 * B + chain];
  q.sigma = scal[1 * B + chain];
  q.gp = scal[2 * B + chain];
  q.gA = scal[3 * B + chain];
  q.gI = scal[4 * B + chain];
  q.gH = scal[5 * B + chain];
  q.gICU = scal[6 * B + chain];
  q.m0 = cst.M[age][0];
  q.m1 = cst.M[age][1];
  q.m2 = cst.M[age][2];
  q.m3 = cst.M[age][3];
  return q;
}

// x if x >= 0 else 0, propagating NaN like torch.maximum / jnp.maximum
template <typename T>
__device__ __forceinline__ T relu(T x) { return x < T(0) ? T(0) : x; }

// the lane's share of sum_j M_ij v_j: four reads inside the lane group
template <typename T>
__device__ __forceinline__ T group_matvec(T v, T m0, T m1, T m2, T m3) {
  const unsigned full = 0xffffffffu;
  const T v0 = __shfl_sync(full, v, 0, kAges);
  const T v1 = __shfl_sync(full, v, 1, kAges);
  const T v2 = __shfl_sync(full, v, 2, kAges);
  const T v3 = __shfl_sync(full, v, 3, kAges);
  return m0 * v0 + m1 * v1 + m2 * v2 + m3 * v3;
}

template <typename T>
__device__ __forceinline__ void rhs(const T (&y)[kCarried], T (&dy)[kCarried],
                                    const Lane<T>& q, T beta) {
  const T ip = (y[2] + y[3] + q.theta * y[4]) * q.hinfN;
  T lam = group_matvec(ip, q.m0, q.m1, q.m2, q.m3);
  lam = relu(beta * (q.a * lam));

  const T fSE = lam * y[0];
  const T fEP = q.sigma * y[1];
  const T fPo = q.gp * y[2];
  const T fPA = q.p * fPo;
  const T fPI = fPo - fPA;
  const T fIH = q.h * y[4];
  const T fIR = q.gI * y[4];
  const T fIDc = q.dcomm * y[4];
  const T fHICU = q.icu * y[5];
  const T dHrow = q.dH * y[5];
  const T dICUrow = q.dICU * y[6];

  dy[0] = -fSE;
  dy[1] = fSE - fEP;
  dy[2] = fEP - fPo;
  dy[3] = fPA - q.gA * y[3];
  dy[4] = fPI - (fIR + fIH + fIDc);
  dy[5] = fIH - (q.gH * y[5] + dHrow + fHICU);
  dy[6] = fHICU - (q.gICU * y[6] + dICUrow);
  dy[7] = dHrow + dICUrow + fIDc;
  dy[8] = fIH;
  dy[9] = fHICU;
}

// sum over the four age lanes of a chain; every lane gets the same bits
template <typename T>
__device__ __forceinline__ T age_sum(T x) {
  const unsigned full = 0xffffffffu;
  x += __shfl_xor_sync(full, x, 1);
  x += __shfl_xor_sync(full, x, 2);
  return x;
}

// this lane's Poisson terms of observation row j: streams deaths, hosp, icu
template <typename T>
__device__ __forceinline__ T poisson_row(const T* __restrict__ obs,
                                         const T* __restrict__ valid, int j,
                                         int age, T inc_d, T inc_h, T inc_i) {
  const int base = j * 3 * kAges + age;
  const T incs[3] = {inc_d, inc_h, inc_i};
  T term = T(0);
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const T o = __ldg(obs + base + s * kAges);
    const T v = __ldg(valid + base + s * kAges);
    term += o * log(incs[s]) - v * incs[s];
  }
  return term;
}

// the stage inputs yi = y + sum_{j<i} a_ij k_j (zero coefficients skipped)
template <typename T, int S>
__device__ __forceinline__ void stage_input(const T (&y)[kCarried],
                                            const T (&k)[S][kCarried], int i,
                                            T (&yi)[kCarried],
                                            const Consts<T>& cst) {
#pragma unroll
  for (int c = 0; c < kCarried; ++c) yi[c] = y[c];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    if (j < i) {
      const T aij = cst.a[i][j];
      if (aij != T(0)) {
#pragma unroll
        for (int c = 0; c < kCarried; ++c) yi[c] = yi[c] + aij * k[j][c];
      }
    }
  }
}

// One daily interval in place: D/CumH/CumICU reset to 0 (the day-end value
// is then the day's incidence), then `substeps` RK steps of h = 1/substeps
// with beta frozen; FSAL tableaus carry the last stage into the next substep.
// `after_substep(sub, y)` sees the state after each substep.
template <typename T, int S, typename Hook>
__device__ __forceinline__ void advance_day(T (&y)[kCarried], const Lane<T>& q,
                                            T beta, int substeps, int fsal,
                                            const Consts<T>& cst,
                                            Hook after_substep) {
  T k[S][kCarried];
  T yi[kCarried];
  y[7] = T(0);
  y[8] = T(0);
  y[9] = T(0);
  rhs(y, k[0], q, beta);
  for (int sub = 0; sub < substeps; ++sub) {
    if (sub > 0) {
      if (fsal) {
#pragma unroll
        for (int c = 0; c < kCarried; ++c) k[0][c] = k[S - 1][c];
      } else {
        rhs(y, k[0], q, beta);
      }
    }
#pragma unroll
    for (int i = 1; i < S; ++i) {
      stage_input<T, S>(y, k, i, yi, cst);
      rhs(yi, k[i], q, beta);
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const T bi = cst.b[i];
      if (bi != T(0)) {
#pragma unroll
        for (int c = 0; c < kCarried; ++c) y[c] = y[c] + bi * k[i][c];
      }
    }
    after_substep(sub, y);
  }
}

template <typename T, int S>
__device__ __forceinline__ void advance_day(T (&y)[kCarried], const Lane<T>& q,
                                            T beta, int substeps, int fsal,
                                            const Consts<T>& cst) {
  advance_day<T, S>(y, q, beta, substeps, fsal, cst,
                    [](int, const T (&)[kCarried]) {});
}

// Launch a kernel templated on the stage count for the tableaus the port
// ships: rk4 (4), cash_karp and rkf45 (6), dopri5 (7), fehlberg78 (13).
#define SEPAIHRD_DISPATCH_STAGES(n_stages, LAUNCH)          \
  switch (n_stages) {                                       \
    case 4: LAUNCH(4); break;                               \
    case 6: LAUNCH(6); break;                               \
    case 7: LAUNCH(7); break;                               \
    case 13: LAUNCH(13); break;                             \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace sepaihrd
