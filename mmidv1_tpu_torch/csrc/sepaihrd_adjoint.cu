// The gradient of the fused SEPAIHRD objective for NVIDIA Hopper (sm_90a):
// K2, the forward solve + fold with day-start checkpoints, and K3, the
// reverse chunked discrete adjoint. Together they are one value_and_grad of
// the log-likelihood with respect to every kernel input.
//
// Replace the Pallas TPU kernels mmidv1_tpu/ops/sepaihrd_adjoint.py
// `_fwd_call` (body `_make_fwd_kernel`) and `_bwd_call` (body
// `_make_bwd_kernel`), and compute what they compute:
//   K2: K1's forward (sepaihrd_fused.cu) on the R-dropped state, plus the
//       PRE-reset day-start state at every day t with t % 24 == 0, into
//       ckpt (n_chunks, 10, 4, B), chains last.
//   K3: per 24-day chunk, last chunk first:
//       phase 1 re-integrates the chunk from its checkpoint into a global
//         scratch of 25 day states (days t >= n_intervals are no-ops);
//       phase 2 sweeps the chunk's days backward: the fold adjoint
//         g * (obs / inc - valid) of day t, read from the state at t+1 and
//         gated by the STRICT mask cv > 0 (as the Pallas adjoint, not the
//         1/2 that jnp.maximum's gradient gives at cv == 0), joins lambda at
//         D/CumH/CumICU; lambda is pulled back through the day's substeps
//         one at a time (substep starts recomputed, each substep transposed
//         by hand: the stage axpys, the 11 flows, the 4x4 contact matvec);
//         lambda's D/CumH/CumICU rows are then zeroed (the transpose of the
//         per-day reset). The max(x, 0) of the force of infection transposes
//         as jax.vjp of jnp.maximum(x, 0) does: 1 for x > 0, 1/2 for x == 0,
//         0 for x < 0.
//       Outputs dLL/dy0 (11, 4, B) (R row 0), dLL/dagevec (8, 4, B),
//       dLL/dscal (7, B) and dLL/dbeff (n_runs, B), for the cotangent g (B,).
//       The Kahan compensation transposes as the plain sum (dLL/dterm = 1).
//
// What bounds them: arithmetic. K2 is K1's arithmetic (~3.9e6 flop per chain
// at dopri5@4 over 325 days) plus 14 checkpoint stores of 40 values. K3's
// function needs, per day and lane, a K1 day (phase 1) and the transpose of
// each substep (about twice the RHS's arithmetic per stage). As built it also
// recomputes the substep starts (substeps - 1 substeps) and, per substep, the
// stage inputs: about four K1 solves in all against the function's 2.6.
// `op_count_adjoint` in ops/sepaihrd_adjoint.py counts both ("bwd" and
// "bwd_design") from this source. K3's scratch traffic (25 x 10 values a
// lane, written and read once per chunk) is ~1.8 GB at B = 8192 in f64,
// ~0.5 ms at 3.35 TB/s, below its arithmetic time.
//
// Design against that bound: the thread mapping and helpers of K1
// (sepaihrd_common.cuh): one thread per (chain, age), shuffles for the
// contact matvec, its transpose and the sum over ages; no shared memory, no
// block barrier. The scratch is private to each thread and laid out
// thread-major ((day * 10 + compartment) * n_threads + tid), so a warp's
// stores and loads are contiguous. One substep's stage inputs and stage
// cotangents (2 x stages x 10 values) and the day's substep starts are
// per-thread arrays the compiler may keep in local memory (ptxas' spill
// report goes to build/sepaihrd_adjoint.ptxas.txt). Each chain owns its
// outputs, so no atomics: d(beta) of the current schedule run is summed in a
// register and flushed, after a lane reduction, when the backward sweep
// crosses into the previous run.
//
// Numerics: no --use_fast_math, accurate log; nvcc's FMA contraction makes
// K2/K3 differ from their plain PyTorch versions by rounding only. Phase 1
// uses K2's own day step (FSAL carried), so the recomputed day states are
// K2's; the substep-start recompute evaluates the first stage afresh, as the
// Pallas adjoint does.

#include "sepaihrd_common.cuh"

namespace {

using namespace sepaihrd;

constexpr int kChunk = 24;       // days per checkpoint (L_CHUNK)
constexpr int kMaxSubsteps = 16;

// parameter cotangent slots: agevec rows 0..7, then scal rows 0..6
enum {
  kA, kHinfN, kP, kH, kIcu, kDH, kDICU, kDcomm,
  kTheta, kSigma, kGp, kGA, kGI, kGH, kGICU, kParams
};

// the contact matrix column of this age: the transposed matvec's weights
template <typename T>
struct Col {
  T m0, m1, m2, m3;
};

// One RK substep in place, every stage evaluated afresh (no FSAL carry).
template <typename T, int S>
__device__ __forceinline__ void one_substep(T (&y)[kCarried], const Lane<T>& q,
                                            T beta, const Consts<T>& cst) {
  T k[S][kCarried];
  T yi[kCarried];
  rhs(y, k[0], q, beta);
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
}

// Transpose of one RHS evaluation at state y: given kap = dL/d(dy), write
// mu = dL/dy and add the parameter cotangents to dq and dbeta.
template <typename T>
__device__ __forceinline__ void rhs_vjp(const T (&y)[kCarried],
                                        const T (&kap)[kCarried],
                                        T (&mu)[kCarried], T (&dq)[kParams],
                                        T& dbeta, const Lane<T>& q,
                                        const Col<T>& mc, T beta) {
  const T S_ = y[0], E_ = y[1], P_ = y[2], A_ = y[3], I_ = y[4], H_ = y[5],
          ICU_ = y[6];
  // forward pieces, as rhs() computes them
  const T s = y[2] + y[3] + q.theta * y[4];
  const T ip = (y[2] + y[3] + q.theta * y[4]) * q.hinfN;
  const T lraw = group_matvec(ip, q.m0, q.m1, q.m2, q.m3);
  const T ax = q.a * lraw;
  const T x = beta * ax;
  const T lam = relu(x);
  const T fPo = q.gp * P_;

  const T c0 = kap[0], c1 = kap[1], c2 = kap[2], c3 = kap[3], c4 = kap[4],
          c5 = kap[5], c6 = kap[6], c7 = kap[7], c8 = kap[8], c9 = kap[9];
  // cotangents of the flows, from the ten derivative rows
  const T c_fSE = c1 - c0;
  const T c_fEP = c2 - c1;
  const T c_fPA = c3 - c4;                  // dA, and fPI = fPo - fPA
  T c_fPo = c4 - c2;                        // fPI, and dP
  const T c_fIH = (c5 + c8) - c4;
  const T c_fIR = -c4;
  const T c_fIDc = c7 - c4;
  const T c_fHICU = (c6 + c9) - c5;
  const T c_dHrow = c7 - c5;
  const T c_dICUrow = c7 - c6;

  dq[kP] += c_fPA * fPo;                    // fPA = p * fPo
  c_fPo += c_fPA * q.p;
  dq[kGp] += c_fPo * P_;                    // fPo = gamma_p * P
  dq[kSigma] += c_fEP * E_;
  dq[kGA] -= c3 * A_;
  dq[kGH] -= c5 * H_;
  dq[kGICU] -= c6 * ICU_;
  dq[kH] += c_fIH * I_;
  dq[kGI] += c_fIR * I_;
  dq[kDcomm] += c_fIDc * I_;
  dq[kIcu] += c_fHICU * H_;
  dq[kDH] += c_dHrow * H_;
  dq[kDICU] += c_dICUrow * ICU_;

  // lam = max(x, 0): jnp.maximum's gradient, 1/2 at the tie
  const T gate = x > T(0) ? T(1) : (x == T(0) ? T(0.5) : T(0));
  const T c_x = (c_fSE * S_) * gate;
  dbeta += c_x * ax;                        // x = beta * (a * lraw)
  const T c_ax = c_x * beta;
  dq[kA] += c_ax * lraw;
  const T c_lr = c_ax * q.a;
  // lraw_i = sum_j M_ij ip_j, so c_ip_j = sum_i M_ij c_lr_i
  const T c_ip = group_matvec(c_lr, mc.m0, mc.m1, mc.m2, mc.m3);
  dq[kHinfN] += c_ip * s;                   // ip = s * hinfN
  const T c_s = c_ip * q.hinfN;
  dq[kTheta] += c_s * I_;                   // s = P + A + theta * I

  mu[0] = c_fSE * lam;
  mu[1] = c_fEP * q.sigma;
  mu[2] = c_fPo * q.gp + c_s;
  mu[3] = c_s - c3 * q.gA;
  mu[4] = c_fIH * q.h + c_fIR * q.gI + c_fIDc * q.dcomm + c_s * q.theta;
  mu[5] = c_fHICU * q.icu + c_dHrow * q.dH - c5 * q.gH;
  mu[6] = c_dICUrow * q.dICU - c6 * q.gICU;
  mu[7] = T(0);                             // D, CumH, CumICU: not read
  mu[8] = T(0);
  mu[9] = T(0);
}

// Pull lam back through one substep started at y: lam becomes dL/dy.
template <typename T, int S>
__device__ __forceinline__ void substep_vjp(const T (&y)[kCarried],
                                            T (&lam)[kCarried],
                                            T (&dq)[kParams], T& dbeta,
                                            const Lane<T>& q, const Col<T>& mc,
                                            T beta, const Consts<T>& cst) {
  T Y[S][kCarried];   // stage inputs
  T K[S][kCarried];   // stage derivatives, then stage cotangents
#pragma unroll
  for (int c = 0; c < kCarried; ++c) Y[0][c] = y[c];
  rhs(Y[0], K[0], q, beta);
#pragma unroll
  for (int i = 1; i < S; ++i) {
    stage_input<T, S>(y, K, i, Y[i], cst);
    rhs(Y[i], K[i], q, beta);
  }
  // kappa_i = b_i lam + sum_{j > i} a_ji mu_j, completed from the last stage
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const T bi = cst.b[i];
#pragma unroll
    for (int c = 0; c < kCarried; ++c) K[i][c] = bi != T(0) ? bi * lam[c] : T(0);
  }
  T mu[kCarried];
#pragma unroll
  for (int i = S - 1; i >= 0; --i) {
    rhs_vjp(Y[i], K[i], mu, dq, dbeta, q, mc, beta);
#pragma unroll
    for (int c = 0; c < kCarried; ++c) lam[c] += mu[c];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (j < i) {
        const T aij = cst.a[i][j];
        if (aij != T(0)) {
#pragma unroll
          for (int c = 0; c < kCarried; ++c) K[j][c] += aij * mu[c];
        }
      }
    }
  }
}

__device__ __forceinline__ int run_of(int t, int n_runs, const int* run_start) {
  int r = 0;
  while (r + 1 < n_runs && run_start[r + 1] <= t) ++r;
  return r;
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
sepaihrd_fwd_ckpt_kernel(const T* __restrict__ y0, const T* __restrict__ agevec,
                         const T* __restrict__ scal, const T* __restrict__ beff,
                         const T* __restrict__ obs, const T* __restrict__ valid,
                         T* __restrict__ out, T* __restrict__ ckpt, int B,
                         int T_obs, int runup_offset, int substeps, int fsal,
                         int n_runs, const Consts<T> cst) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int age = tid & (kAges - 1);
  const bool active = (tid >> 2) < B;
  const int chain = active ? (tid >> 2) : B - 1;
  const size_t AB = static_cast<size_t>(kAges) * B;
  const size_t at = static_cast<size_t>(age) * B + chain;
  const T eps = T(1e-10);
  const Lane<T> q = load_lane(agevec, scal, cst, age, chain, B);

  T y[kCarried];
#pragma unroll
  for (int c = 0; c < kCarried; ++c) {
    const int row = c < 7 ? c : c + 1;
    y[c] = y0[row * AB + at];
  }

  T ll = T(0), comp = T(0);
  if (runup_offset == 0) {
    ll = ll + age_sum(poisson_row(obs, valid, 0, age, eps, eps, eps));
  }

  for (int r = 0; r < n_runs; ++r) {
    const T beta = beff[static_cast<size_t>(r) * B + chain];
    const int t_end = cst.run_start[r] + cst.run_count[r];
    for (int t = cst.run_start[r]; t < t_end; ++t) {
      if (t % kChunk == 0 && active) {
        // the PRE-reset day-start state: K3 applies the same reset
        T* dst = ckpt + static_cast<size_t>(t / kChunk) * kCarried * AB + at;
#pragma unroll
        for (int c = 0; c < kCarried; ++c) dst[c * AB] = y[c];
      }
      advance_day<T, S>(y, q, beta, substeps, fsal, cst);
      const int j = t + 1 - runup_offset;
      if (j >= 0 && j < T_obs) {
        const T term = age_sum(poisson_row(obs, valid, j, age, relu(y[7]) + eps,
                                           relu(y[8]) + eps, relu(y[9]) + eps));
        const T contrib = term - comp;
        const T ll_new = ll + contrib;
        comp = (ll_new - ll) - contrib;
        ll = ll_new;
      }
    }
  }
  if (active && age == 0) out[chain] = ll;
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
sepaihrd_adjoint_kernel(const T* __restrict__ agevec, const T* __restrict__ scal,
                        const T* __restrict__ beff, const T* __restrict__ obs,
                        const T* __restrict__ valid, const T* __restrict__ ckpt,
                        const T* __restrict__ g, T* __restrict__ dy0,
                        T* __restrict__ dagevec, T* __restrict__ dscal,
                        T* __restrict__ dbeff, T* __restrict__ scratch, int B,
                        int T_obs, int runup_offset, int substeps, int fsal,
                        int n_runs, int n_intervals, int n_chunks,
                        const Consts<T> cst) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n_threads = static_cast<size_t>(gridDim.x) * blockDim.x;
  const int age = tid & (kAges - 1);
  const bool active = (tid >> 2) < B;
  const int chain = active ? (tid >> 2) : B - 1;
  const size_t AB = static_cast<size_t>(kAges) * B;
  const size_t at = static_cast<size_t>(age) * B + chain;
  const T eps = T(1e-10);
  const Lane<T> q = load_lane(agevec, scal, cst, age, chain, B);
  const Col<T> mc = {cst.M[0][age], cst.M[1][age], cst.M[2][age], cst.M[3][age]};
  const T gll = g[chain];
  // this thread's day state k, compartment c
  T* const days = scratch + tid;
  auto slot = [&](int k, int c) -> T& { return days[(k * kCarried + c) * n_threads]; };

  T lam[kCarried];
#pragma unroll
  for (int c = 0; c < kCarried; ++c) lam[c] = T(0);
  T dq[kParams];
#pragma unroll
  for (int p = 0; p < kParams; ++p) dq[p] = T(0);
  int rb = n_runs - 1;                      // schedule run of the backward day
  T beta_b = beff[static_cast<size_t>(rb) * B + chain];
  T dbeta = T(0);
  T ys[kMaxSubsteps][kCarried];             // the day's substep starts

  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    // phase 1: re-integrate the chunk, storing the 25 day-start states
    T y[kCarried];
    const T* src = ckpt + static_cast<size_t>(ch) * kCarried * AB + at;
#pragma unroll
    for (int c = 0; c < kCarried; ++c) y[c] = src[c * AB];
    for (int k = 0; k < kChunk; ++k) {
      const int t = ch * kChunk + k;
#pragma unroll
      for (int c = 0; c < kCarried; ++c) slot(k, c) = y[c];
      if (t < n_intervals) {
        const int r = run_of(t, n_runs, cst.run_start);
        advance_day<T, S>(y, q, beff[static_cast<size_t>(r) * B + chain],
                          substeps, fsal, cst);
      }
    }
#pragma unroll
    for (int c = 0; c < kCarried; ++c) slot(kChunk, c) = y[c];

    // phase 2: the chunk's days backward
    for (int k = kChunk - 1; k >= 0; --k) {
      const int t = ch * kChunk + k;
      if (t >= n_intervals) continue;
      while (t < cst.run_start[rb]) {       // crossed into the previous run
        const T tot = age_sum(dbeta);
        if (active && age == 0) dbeff[static_cast<size_t>(rb) * B + chain] = tot;
        dbeta = T(0);
        --rb;
        beta_b = beff[static_cast<size_t>(rb) * B + chain];
      }
      // fold adjoint of day t: its incidence is the state at t+1
      const int j = t + 1 - runup_offset;
      if (j >= 0 && j < T_obs) {
        const int base = j * 3 * kAges + age;
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          const T cv = slot(k + 1, 7 + s);
          const T inc = relu(cv) + eps;
          const T o = __ldg(obs + base + s * kAges);
          const T v = __ldg(valid + base + s * kAges);
          const T d = (o * gll) / inc - v * gll;
          lam[7 + s] += cv > T(0) ? d : T(0);
        }
      }
      // the day: reset, then substeps; recompute the substep starts
#pragma unroll
      for (int c = 0; c < kCarried; ++c) ys[0][c] = c < 7 ? slot(k, c) : T(0);
      for (int sub = 1; sub < substeps; ++sub) {
        T yy[kCarried];
#pragma unroll
        for (int c = 0; c < kCarried; ++c) yy[c] = ys[sub - 1][c];
        one_substep<T, S>(yy, q, beta_b, cst);
#pragma unroll
        for (int c = 0; c < kCarried; ++c) ys[sub][c] = yy[c];
      }
      for (int sub = substeps - 1; sub >= 0; --sub) {
        T yy[kCarried];
#pragma unroll
        for (int c = 0; c < kCarried; ++c) yy[c] = ys[sub][c];
        substep_vjp<T, S>(yy, lam, dq, dbeta, q, mc, beta_b, cst);
      }
      // transpose of the reset: the zeroed rows take no cotangent
      lam[7] = T(0);
      lam[8] = T(0);
      lam[9] = T(0);
    }
  }
  {
    const T tot = age_sum(dbeta);
    if (active && age == 0) dbeff[static_cast<size_t>(rb) * B + chain] = tot;
  }
  T dsc[7];
#pragma unroll
  for (int p = 0; p < 7; ++p) dsc[p] = age_sum(dq[kTheta + p]);
  if (!active) return;
#pragma unroll
  for (int c = 0; c < kCarried; ++c) {
    const int row = c < 7 ? c : c + 1;
    dy0[row * AB + at] = lam[c];
  }
  dy0[7 * AB + at] = T(0);                  // R: nothing reads it
#pragma unroll
  for (int p = 0; p < 8; ++p) dagevec[p * AB + at] = dq[p];
  if (age == 0) {
#pragma unroll
    for (int p = 0; p < 7; ++p) dscal[static_cast<size_t>(p) * B + chain] = dsc[p];
  }
}

template <typename T>
bool check(int B, int T_obs, int runup_offset, int substeps, int n_runs,
           const int* run_start, const int* run_count, int n_chunks,
           int* n_intervals) {
  if (B < 1 || T_obs < 1 || substeps < 1 || n_runs < 1 || n_runs > kMaxRuns ||
      runup_offset < 0)
    return false;
  int n = 0;
  for (int r = 0; r < n_runs; ++r) {
    if (run_start[r] != n || run_count[r] < 1) return false;
    n += run_count[r];
  }
  *n_intervals = n;
  return n_chunks == (n + kChunk - 1) / kChunk;
}

template <typename T>
int launch_fwd(const T* y0, const T* agevec, const T* scal, const T* beff,
               const T* obs, const T* valid, T* out, T* ckpt, int B, int T_obs,
               int runup_offset, int substeps, int n_stages, int fsal,
               const double* a_host, const double* b_host, const double* M_host,
               int n_runs, const int* run_start, const int* run_count,
               int n_chunks, void* stream) {
  Consts<T> c;
  int n_intervals = 0;
  if (!check<T>(B, T_obs, runup_offset, substeps, n_runs, run_start, run_count,
                n_chunks, &n_intervals) ||
      !make_consts(c, n_stages, a_host, b_host, M_host, n_runs, run_start,
                   run_count)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long threads_total = static_cast<long long>(kAges) * B;
  const int blocks = static_cast<int>((threads_total + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MMIDV1_LAUNCH(NS)                                                     \
  sepaihrd_fwd_ckpt_kernel<T, NS><<<blocks, kThreads, 0, s>>>(                \
      y0, agevec, scal, beff, obs, valid, out, ckpt, B, T_obs, runup_offset,  \
      substeps, fsal, n_runs, c)
  SEPAIHRD_DISPATCH_STAGES(n_stages, MMIDV1_LAUNCH)
#undef MMIDV1_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const T* agevec, const T* scal, const T* beff, const T* obs,
               const T* valid, const T* ckpt, const T* g, T* dy0, T* dagevec,
               T* dscal, T* dbeff, T* scratch, long long scratch_len, int B,
               int T_obs, int runup_offset, int substeps, int n_stages,
               int fsal, const double* a_host, const double* b_host,
               const double* M_host, int n_runs, const int* run_start,
               const int* run_count, int n_chunks, void* stream) {
  Consts<T> c;
  int n_intervals = 0;
  if (!check<T>(B, T_obs, runup_offset, substeps, n_runs, run_start, run_count,
                n_chunks, &n_intervals) ||
      substeps > kMaxSubsteps ||
      !make_consts(c, n_stages, a_host, b_host, M_host, n_runs, run_start,
                   run_count)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long threads_total = static_cast<long long>(kAges) * B;
  const int blocks = static_cast<int>((threads_total + kThreads - 1) / kThreads);
  const long long need =
      static_cast<long long>(kChunk + 1) * kCarried * blocks * kThreads;
  if (scratch_len < need) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MMIDV1_LAUNCH(NS)                                                     \
  sepaihrd_adjoint_kernel<T, NS><<<blocks, kThreads, 0, s>>>(                 \
      agevec, scal, beff, obs, valid, ckpt, g, dy0, dagevec, dscal, dbeff,    \
      scratch, B, T_obs, runup_offset, substeps, fsal, n_runs, n_intervals,   \
      n_chunks, c)
  SEPAIHRD_DISPATCH_STAGES(n_stages, MMIDV1_LAUNCH)
#undef MMIDV1_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sepaihrd_fwd_ckpt_f32(const float* y0, const float* agevec,
                          const float* scal, const float* beff,
                          const float* obs, const float* valid, float* out,
                          float* ckpt, int B, int T_obs, int runup_offset,
                          int substeps, int n_stages, int fsal,
                          const double* a_host, const double* b_host,
                          const double* M_host, int n_runs,
                          const int* run_start, const int* run_count,
                          int n_chunks, void* stream) {
  return launch_fwd<float>(y0, agevec, scal, beff, obs, valid, out, ckpt, B,
                           T_obs, runup_offset, substeps, n_stages, fsal,
                           a_host, b_host, M_host, n_runs, run_start,
                           run_count, n_chunks, stream);
}

int sepaihrd_fwd_ckpt_f64(const double* y0, const double* agevec,
                          const double* scal, const double* beff,
                          const double* obs, const double* valid, double* out,
                          double* ckpt, int B, int T_obs, int runup_offset,
                          int substeps, int n_stages, int fsal,
                          const double* a_host, const double* b_host,
                          const double* M_host, int n_runs,
                          const int* run_start, const int* run_count,
                          int n_chunks, void* stream) {
  return launch_fwd<double>(y0, agevec, scal, beff, obs, valid, out, ckpt, B,
                            T_obs, runup_offset, substeps, n_stages, fsal,
                            a_host, b_host, M_host, n_runs, run_start,
                            run_count, n_chunks, stream);
}

int sepaihrd_adjoint_f32(const float* agevec, const float* scal,
                         const float* beff, const float* obs,
                         const float* valid, const float* ckpt, const float* g,
                         float* dy0, float* dagevec, float* dscal,
                         float* dbeff, float* scratch, long long scratch_len,
                         int B, int T_obs, int runup_offset, int substeps,
                         int n_stages, int fsal, const double* a_host,
                         const double* b_host, const double* M_host,
                         int n_runs, const int* run_start,
                         const int* run_count, int n_chunks, void* stream) {
  return launch_bwd<float>(agevec, scal, beff, obs, valid, ckpt, g, dy0,
                           dagevec, dscal, dbeff, scratch, scratch_len, B,
                           T_obs, runup_offset, substeps, n_stages, fsal,
                           a_host, b_host, M_host, n_runs, run_start,
                           run_count, n_chunks, stream);
}

int sepaihrd_adjoint_f64(const double* agevec, const double* scal,
                         const double* beff, const double* obs,
                         const double* valid, const double* ckpt,
                         const double* g, double* dy0, double* dagevec,
                         double* dscal, double* dbeff, double* scratch,
                         long long scratch_len, int B, int T_obs,
                         int runup_offset, int substeps, int n_stages,
                         int fsal, const double* a_host, const double* b_host,
                         const double* M_host, int n_runs,
                         const int* run_start, const int* run_count,
                         int n_chunks, void* stream) {
  return launch_bwd<double>(agevec, scal, beff, obs, valid, ckpt, g, dy0,
                            dagevec, dscal, dbeff, scratch, scratch_len, B,
                            T_obs, runup_offset, substeps, n_stages, fsal,
                            a_host, b_host, M_host, n_runs, run_start,
                            run_count, n_chunks, stream);
}

const char* sepaihrd_adjoint_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
