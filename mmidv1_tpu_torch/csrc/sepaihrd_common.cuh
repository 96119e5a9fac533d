// Device helpers shared by the SEPAIHRD kernels: the forward recurrence K1
// and K2 (sepaihrd_forward.cuh, instantiated by sepaihrd_fused.cu and
// sepaihrd_adjoint.cu) and the adjoint K3 (sepaihrd_adjoint.cu). They replace
// the Pallas TPU kernels mmidv1_tpu/ops/sepaihrd_pallas.py `fused_objective`
// and mmidv1_tpu/ops/sepaihrd_adjoint.py `_fwd_call` / `_bwd_call`; the
// headers of those sources say what bounds each kernel (the roofline, by
// arithmetic, and the dependency chain of RK stages) and what its design
// does about the chain.
//
// Thread mapping of every kernel: one thread per (chain, age) in groups of
// four lanes (age = lane & 3). A chain's 10 carried compartments S E P A I H
// ICU D CumH CumICU live in registers (R is absorbing, unread and
// unobserved, so it is not carried): all ten in one thread, or the model's
// two halves (rhs_up, rhs_down) in the same lane of a producer and a
// consumer warp. The 4x4 contact matvec is four __shfl_sync reads inside the
// lane group and the sum over ages two __shfl_xor_sync steps. Lane groups
// past the last chain mirror the last chain so every shuffle has a full
// warp; they store nothing.

#pragma once

#include <cuda_runtime.h>

namespace sepaihrd {

constexpr int kMaxStages = 13;   // fehlberg78
constexpr int kMaxRuns = 64;
constexpr int kAges = 4;
constexpr int kCarried = 10;     // S E P A I H ICU D CumH CumICU (R dropped)
constexpr int kUp = 5;           // S E P A I: the infection subsystem
constexpr int kDown = 5;         // H ICU D CumH CumICU: linear rows behind I
constexpr int kChunk = 24;       // days per checkpoint (L_CHUNK)
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

// The model is a cascade. S E P A I are a closed nonlinear subsystem: the
// force of infection reads P, A and I only. H ICU D CumH CumICU are linear
// rows driven by I that never feed back. rhs_up and rhs_down are the two
// halves; rhs is both, and every kernel gets its derivatives from them.

// d/dt of S E P A I from their own state u (the contact matvec is here)
template <typename T>
__device__ __forceinline__ void rhs_up(const T* u, T* du, const Lane<T>& q,
                                       T beta) {
  const T ip = (u[2] + u[3] + q.theta * u[4]) * q.hinfN;
  T lam = group_matvec(ip, q.m0, q.m1, q.m2, q.m3);
  lam = relu(beta * (q.a * lam));

  const T fSE = lam * u[0];
  const T fEP = q.sigma * u[1];
  const T fPo = q.gp * u[2];
  const T fPA = q.p * fPo;
  const T fPI = fPo - fPA;
  const T fIH = q.h * u[4];
  const T fIR = q.gI * u[4];
  const T fIDc = q.dcomm * u[4];

  du[0] = -fSE;
  du[1] = fSE - fEP;
  du[2] = fEP - fPo;
  du[3] = fPA - q.gA * u[3];
  du[4] = fPI - (fIR + fIH + fIDc);
}

// d/dt of H ICU D CumH CumICU from I and their own state z (z[0] = H,
// z[1] = ICU; D, CumH and CumICU are not read)
template <typename T>
__device__ __forceinline__ void rhs_down(T I, const T* z, T* dz,
                                         const Lane<T>& q) {
  const T fIH = q.h * I;
  const T fIDc = q.dcomm * I;
  const T fHICU = q.icu * z[0];
  const T dHrow = q.dH * z[0];
  const T dICUrow = q.dICU * z[1];

  dz[0] = fIH - (q.gH * z[0] + dHrow + fHICU);
  dz[1] = fHICU - (q.gICU * z[1] + dICUrow);
  dz[2] = dHrow + dICUrow + fIDc;
  dz[3] = fIH;
  dz[4] = fHICU;
}

template <typename T>
__device__ __forceinline__ void rhs(const T (&y)[kCarried], T (&dy)[kCarried],
                                    const Lane<T>& q, T beta) {
  rhs_up(y, dy, q, beta);
  rhs_down(y[4], y + kUp, dy + kUp, q);
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

// y += a * k over R rows. With SKIP a zero coefficient is skipped, as the
// plain version skips it, so a non-finite k behind a zero poisons nothing
// (K3's kernels). Without, the FMA runs whatever a is (the forward kernels):
// fma(0, k, y) is y for every finite k, and no branch or predicate stands
// between the stages. A non-finite k behind a zero then turns y NaN where
// SKIP would have passed it by. Mostly such a chain ends NaN either way, one
// stage later; the exception is a stage that is discarded: the last stage
// of a day's last substep under a tableau whose last b is 0 (dopri5's k[6])
// is never carried, since the next day starts fresh, so a non-finite k there
// (reachable only near overflow) gives NaN here and a finite value in the
// plain version and in K3's `days` kernel, which re-integrates with SKIP on.
// The two rules also differ in the sign of zero: fma(0, k, -0) is +0. When
// K3's flag is flipped, flip it for `days` in the same change, so that K2's
// checkpoints and K3's re-integration keep one rule.
template <typename T, int R, bool SKIP>
__device__ __forceinline__ void axpy_rows(T (&y)[R], T a, const T (&k)[R]) {
  if (!SKIP || a != T(0)) {
#pragma unroll
    for (int c = 0; c < R; ++c) y[c] = y[c] + a * k[c];
  }
}

// the stage inputs yi = y + sum_{j<i} a_ij k_j over R rows
template <typename T, int S, int R, bool SKIP = true>
__device__ __forceinline__ void stage_input(const T (&y)[R],
                                            const T (&k)[S][R], int i,
                                            T (&yi)[R], const Consts<T>& cst) {
#pragma unroll
  for (int c = 0; c < R; ++c) yi[c] = y[c];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    if (j < i) axpy_rows<T, R, SKIP>(yi, cst.a[i][j], k[j]);
  }
}

// One RK step of R rows in place. `stage(i, yi, ki)` writes the derivative
// ki at the stage input yi. The first stage is evaluated when `fresh`, else
// it is the last stage of the step before (FSAL), which k still holds.
template <typename T, int S, int R, bool SKIP = true, typename Stage>
__device__ __forceinline__ void rk_substep(T (&y)[R], T (&k)[S][R], bool fresh,
                                           const Consts<T>& cst, Stage stage) {
  T yi[R];
  if (fresh) {
    stage(0, y, k[0]);
  } else {
#pragma unroll
    for (int c = 0; c < R; ++c) k[0][c] = k[S - 1][c];
  }
#pragma unroll
  for (int i = 1; i < S; ++i) {
    stage_input<T, S, R, SKIP>(y, k, i, yi, cst);
    stage(i, yi, k[i]);
  }
#pragma unroll
  for (int i = 0; i < S; ++i) axpy_rows<T, R, SKIP>(y, cst.b[i], k[i]);
}

// One daily interval in place: D/CumH/CumICU reset to 0 (the day-end value
// is then the day's incidence), then `substeps` RK steps of h = 1/substeps
// with beta frozen; FSAL tableaus carry the last stage into the next substep.
// `after_substep(sub, y)` sees the state after each substep. SKIP as in
// axpy_rows.
template <typename T, int S, bool SKIP = true, typename Hook>
__device__ __forceinline__ void advance_day(T (&y)[kCarried], const Lane<T>& q,
                                            T beta, int substeps, int fsal,
                                            const Consts<T>& cst,
                                            Hook after_substep) {
  T k[S][kCarried];
  y[7] = T(0);
  y[8] = T(0);
  y[9] = T(0);
  for (int sub = 0; sub < substeps; ++sub) {
    rk_substep<T, S, kCarried, SKIP>(
        y, k, sub == 0 || !fsal, cst,
        [&](int, const T (&yi)[kCarried], T (&ki)[kCarried]) {
          rhs(yi, ki, q, beta);
        });
    after_substep(sub, y);
  }
}

template <typename T, int S, bool SKIP = true>
__device__ __forceinline__ void advance_day(T (&y)[kCarried], const Lane<T>& q,
                                            T beta, int substeps, int fsal,
                                            const Consts<T>& cst) {
  advance_day<T, S, SKIP>(y, q, beta, substeps, fsal, cst,
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
