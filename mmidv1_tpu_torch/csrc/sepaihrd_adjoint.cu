// The gradient of the fused SEPAIHRD objective for NVIDIA Hopper (sm_90a):
// K2, the forward solve + fold with day-start checkpoints, and K3, the
// reverse discrete adjoint. Together they are one value_and_grad of the
// log-likelihood with respect to every kernel input.
//
// Replace the Pallas TPU kernels mmidv1_tpu/ops/sepaihrd_adjoint.py
// `_fwd_call` (body `_make_fwd_kernel`) and `_bwd_call` (body
// `_make_bwd_kernel`), and compute what they compute:
//   K2: K1's forward on the R-dropped state, plus the PRE-reset day-start
//       state at every day t with t % 24 == 0, into ckpt (n_chunks, 10, 4,
//       B), chains last. Its kernels are K1's with the checkpoint stores
//       switched on, in sepaihrd_forward.cuh: that header has its two
//       bounds (the roofline and the chain of 8125 dependent RK stages) and
//       its two regimes (split: the infection subsystem on producer warps,
//       the linear rows, the fold and their half of each checkpoint on
//       consumer warps behind a shared-memory ring; wide: one thread per
//       (chain, age)). K3 reads ll and ckpt the same from either.
//   K3: from the checkpoints and the cotangent g (B,), dLL/dy0 (11, 4, B)
//       (R row 0), dLL/dagevec (8, 4, B), dLL/dscal (7, B) and dLL/dbeff
//       (n_runs, B). The days are swept backward: the fold adjoint
//       g * (obs / inc - valid) of day t, read from the state at t+1 and
//       gated by the STRICT mask cv > 0 (as the Pallas adjoint, not the 1/2
//       that jnp.maximum's gradient gives at cv == 0), joins lambda at
//       D/CumH/CumICU; lambda is pulled back through the day's substeps one
//       at a time, each transposed by hand (the stage axpys, the 11 flows,
//       the 4x4 contact matvec); lambda's D/CumH/CumICU rows are then zeroed
//       (the transpose of the per-day reset). The max(x, 0) of the force of
//       infection transposes as jax.vjp of jnp.maximum(x, 0) does: 1 for
//       x > 0, 1/2 for x == 0, 0 for x < 0. The Kahan compensation
//       transposes as the plain sum (dLL/dterm = 1).
//
// What bounds K3: arithmetic in the roofline's terms (its function is
// ~1.0e7 flop per chain at dopri5@4 over 325 days: one re-integration from
// the checkpoints plus the transpose of every substep), but at the chain
// counts the samplers use the time is the latency of the dependency chain,
// one RK stage after the other, so K3 is built to shorten that chain and to
// fit its registers. `op_count_adjoint` in ops/sepaihrd_adjoint.py
// counts the function's least arithmetic and each regime's own.
//
// K3's design: stages that each expose the parallelism they have, launched
// back to back on one stream. Every stage keeps K1's thread mapping, four
// age lanes per lane group with shuffles for the contact matvec, its
// transpose and the sum over ages; what a lane group stands for differs.
//   days     one lane group per (chain, chunk): re-integrates the chunk's 24
//            days from its checkpoint with K2's own day step (FSAL carried,
//            so the states are K2's to the bit) and stores the state after
//            every substep, thread-major ((day * substeps + sub) * 10 + c) *
//            4B + chain * 4 + age, so a warp's accesses are contiguous. All
//            chunks of a wave run at once. A substep's start is the end of
//            the one before (of the day before, reset; of the checkpoint),
//            so nothing is recomputed to find it.
//   Regime 2, many chains (the sweep is throughput-bound):
//   sweep    one lane group per chain, the chunks of a wave last to first:
//            per substep the stage inputs are recomputed into a private
//            slot of dynamic shared memory (stages x 7 values a thread),
//            then the substep is transposed with the stage cotangents in
//            registers. Only the 7 rows the RHS reads are kept per stage:
//            rows D/CumH/CumICU of a stage cotangent are b_i * lambda
//            always. lambda, the parameter cotangents and the open run's
//            d(beta) pass from one wave's launch to the next through a
//            small carry buffer; the scratch of a wave is bounded by the
//            caller (wave_chunks).
//   Regime 1, few chains (the sweep is latency-bound): the backward sweep is
//   affine in the lambda that enters a chunk from the later one, and that
//   lambda has 7 x 4 non-zero entries (the reset zeroes the rest). So the
//   chunks are swept all at once:
//   stages   one lane group per (chain, day, substep): the stage inputs and
//            their contact matvec, written once (stages x 8 values a lane).
//   chunk    one block per (chain, chunk), 29 lane groups: one particular
//            sweep (lambda = 0 entering, the fold adjoint as source) and 28
//            homogeneous ones (a unit lambda each, no source). All read the
//            same stage rows from shared memory, where the next substep's
//            are fetched while this one is transposed.
//            Each leaves its outgoing lambda (28), its parameter cotangents
//            (8 x 4 by age, 7 by chain) and d(beta) per (chunk, run)
//            segment: the columns of the chunk's affine map.
//   compose  one block per chain walks the chunks last to first in float64,
//            lambda <- A_c lambda + b_c, dq += G_c lambda + h_c, with the
//            28-term products written out, and writes the four outputs.
//   The serial chain per call falls from 14 chunks x (24 days of forward +
//   24 days of recompute and transpose) to 24 days of forward, 24 days of
//   transpose and 14 small products, at 29 x the transpose arithmetic.
// No atomics: every output has one owner thread, every sum a fixed order.
//
// Numerics: no --use_fast_math, accurate log and division; nvcc's FMA
// contraction makes K2/K3 differ from their plain PyTorch versions by
// rounding only. Stage inputs are computed from the substep's start with
// every first stage evaluated afresh, as the Pallas adjoint does. Every
// kernel is templated on the tableau's type and follows the zero rule of
// sepaihrd_common.cuh: a zero a_ij or b_i emits no instruction, a zero b_i
// seeds its stage cotangent with exactly 0, and a dead stage (dopri5's
// last, fehlberg78's stage 10) is neither recomputed nor transposed, as
// jax.vjp of the Pallas adjoint's substep never transposes it.

#include "sepaihrd_forward.cuh"

namespace {

using namespace sepaihrd;

constexpr int kRhsRows = 7;      // S E P A I H ICU: the rows the RHS reads
constexpr int kStageRows = kRhsRows + 1;         // regime 1 keeps lraw too
constexpr int kSeam = kRhsRows * kAges;          // non-zero lambda entries
constexpr int kSweeps = 1 + kSeam;               // particular + homogeneous
constexpr int kOutRows = kSeam + 8 * kAges + 7;  // lambda, dagevec, dscal
constexpr int kCarry = kRhsRows + 15 + 1;        // lambda, dq, open d(beta)
constexpr int kComposeThreads = 96 + kMaxRuns;   // rows, then one per run

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

// The stage inputs Y_i = y + sum_{j<i} a_ij k_j of one substep started at y,
// every stage evaluated afresh; put(i, Y_i) takes each live one (rows 0..6
// matter). Only the stages a later stage input reads are evaluated.
template <typename Tab, typename T, typename Put>
__device__ __forceinline__ void stage_inputs(const T (&y)[kCarried],
                                             const Lane<T>& q, T beta,
                                             const Consts<T>& cst, Put put) {
  T k[Tab::S][kCarried];
  put(0, y);
  if constexpr (feeds<Tab>(0)) rhs(y, k[0], q, beta);
  static_for<Tab::S - 1>([&](auto M) {
    constexpr int i = decltype(M)::value + 1;
    if constexpr (live<Tab>(i)) {
      T yi[kCarried];
      stage_input<Tab, i>(y, k, yi, cst);
      put(i, yi);
      if constexpr (feeds<Tab>(i)) rhs(yi, k[i], q, beta);
    }
  });
}

// the contact matvec of a state's infectious pressure, as rhs() computes it
template <typename T>
__device__ __forceinline__ T raw_force(const T* y, const Lane<T>& q) {
  const T ip = (y[2] + y[3] + q.theta * y[4]) * q.hinfN;
  return group_matvec(ip, q.m0, q.m1, q.m2, q.m3);
}

// Transpose of one RHS evaluation at state y (its 7 read rows; lraw =
// raw_force(y)): given kap = dL/d(dy), write mu = dL/dy (rows 0..6; D, CumH
// and CumICU are not read, so theirs is 0) and add the parameter cotangents
// to dq and dbeta.
template <typename T>
__device__ __forceinline__ void rhs_vjp(const T (&y)[kRhsRows], T lraw,
                                        const T (&kap)[kCarried],
                                        T (&mu)[kRhsRows], T (&dq)[kParams],
                                        T& dbeta, const Lane<T>& q,
                                        const Col<T>& mc, T beta) {
  const T S_ = y[0], E_ = y[1], P_ = y[2], A_ = y[3], I_ = y[4], H_ = y[5],
          ICU_ = y[6];
  // forward pieces, as rhs() computes them
  const T s = y[2] + y[3] + q.theta * y[4];
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
}

// Pull lam back through one substep whose stage inputs and their raw force
// stage(i, Y_i, lraw_i) gives: lam becomes dL/d(substep start). Stage
// cotangents kappa_i = b_i lam + sum_{j > i} a_ji mu_j, completed from the
// last stage; their rows 7..9 are b_i lam always (mu's are 0), so only rows
// 0..6 are kept. A zero b_i seeds kappa_i with 0, a zero a_ji adds nothing,
// and a dead stage (kappa_i = 0 by its pattern) is not transposed.
template <typename Tab, typename T, typename Get>
__device__ __forceinline__ void substep_vjp(Get stage, T (&lam)[kCarried],
                                            T (&dq)[kParams], T& dbeta,
                                            const Lane<T>& q, const Col<T>& mc,
                                            T beta, const Consts<T>& cst) {
  T K[Tab::S][kRhsRows];
  static_for<Tab::S>([&](auto I) {
    constexpr int i = decltype(I)::value;
#pragma unroll
    for (int c = 0; c < kRhsRows; ++c) {
      if constexpr (b_nz<Tab>(i)) K[i][c] = cst.b[i] * lam[c];
      else K[i][c] = T(0);
    }
  });
  static_for<Tab::S, true>([&](auto I) {
    constexpr int i = decltype(I)::value;
    if constexpr (live<Tab>(i)) {
      T yi[kRhsRows], kap[kCarried], mu[kRhsRows], lraw;
      stage(i, yi, lraw);
#pragma unroll
      for (int c = 0; c < kRhsRows; ++c) kap[c] = K[i][c];
#pragma unroll
      for (int c = kRhsRows; c < kCarried; ++c) {
        if constexpr (b_nz<Tab>(i)) kap[c] = cst.b[i] * lam[c];
        else kap[c] = T(0);
      }
      rhs_vjp(yi, lraw, kap, mu, dq, dbeta, q, mc, beta);
#pragma unroll
      for (int c = 0; c < kRhsRows; ++c) lam[c] += mu[c];
      static_for<i>([&](auto J) {
        constexpr int j = decltype(J)::value;
        if constexpr (a_nz<Tab>(i, j)) {
#pragma unroll
          for (int c = 0; c < kRhsRows; ++c) K[j][c] += cst.a[i][j] * mu[c];
        }
      });
    }
  });
}

__device__ __forceinline__ int run_of(int t, int n_runs, const int* run_start) {
  int r = 0;
  while (r + 1 < n_runs && run_start[r + 1] <= t) ++r;
  return r;
}

// Where the scratch of the days stage keeps the state after substep `sub`
// of day t (t0 = first day of the wave), compartment 0, for this lane.
__device__ __forceinline__ size_t end_slot(int t, int t0, int sub, int substeps,
                                           size_t lanes, size_t lane) {
  return (static_cast<size_t>(t - t0) * substeps + sub) * kCarried * lanes + lane;
}

// The rows the RHS reads of the state substep `sub` of day t starts from:
// the end of the substep before, of the day before, or the checkpoint (the
// reset touches only rows the RHS does not read).
template <typename T>
__device__ __forceinline__ void load_start(T (&y)[kCarried],
                                           const T* __restrict__ ends,
                                           const T* __restrict__ ckpt, int t,
                                           int t0, int sub, int substeps,
                                           size_t lanes, size_t lane, int age,
                                           int chain, int B) {
  const T* src;
  if (sub > 0) {
    src = ends + end_slot(t, t0, sub - 1, substeps, lanes, lane);
  } else if (t % kChunk != 0) {
    src = ends + end_slot(t - 1, t0, substeps - 1, substeps, lanes, lane);
  } else {
    src = ckpt + static_cast<size_t>(t / kChunk) * kCarried * lanes +
          static_cast<size_t>(age) * B + chain;
  }
#pragma unroll
  for (int c = 0; c < kRhsRows; ++c) y[c] = src[c * lanes];
  y[7] = T(0);
  y[8] = T(0);
  y[9] = T(0);
}

// The fold adjoint of day t joins lam at D/CumH/CumICU: the day's incidence
// is the state `end` (compartment 0 of this lane, stride lanes) after it.
template <typename T>
__device__ __forceinline__ void fold_adjoint(T (&lam)[kCarried],
                                             const T* __restrict__ end,
                                             size_t lanes,
                                             const T* __restrict__ obs,
                                             const T* __restrict__ valid, int t,
                                             int runup_offset, int T_obs,
                                             int age, T gll) {
  const int j = t + 1 - runup_offset;
  if (j < 0 || j >= T_obs) return;
  const T eps = T(1e-10);
  const int base = j * 3 * kAges + age;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const T cv = end[(7 + s) * lanes];
    const T inc = relu(cv) + eps;
    const T o = __ldg(obs + base + s * kAges);
    const T v = __ldg(valid + base + s * kAges);
    const T d = (o * gll) / inc - v * gll;
    lam[7 + s] += cv > T(0) ? d : T(0);
  }
}

// K3 stage "days": the chunks [c_lo, c_lo + n_wave_chunks) re-integrated
// from their checkpoints, one lane group per (chain, chunk); the state
// after every substep goes to `ends`. Lane groups past the last mirror it
// and days past the last interval are computed and dropped, so that every
// shuffle has a full warp.
template <typename T, typename Tab>
__global__ void __launch_bounds__(kThreads)
sepaihrd_adjoint_days_kernel(const T* __restrict__ agevec,
                             const T* __restrict__ scal,
                             const T* __restrict__ beff,
                             const T* __restrict__ ckpt, T* __restrict__ ends,
                             int B, int substeps, int n_runs, int n_intervals,
                             int c_lo, int n_wave_chunks, const Consts<T> cst) {
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long groups = static_cast<long long>(B) * n_wave_chunks;
  const bool active = (gid >> 2) < groups;
  const long long lg = active ? (gid >> 2) : groups - 1;
  const int age = static_cast<int>(gid & (kAges - 1));
  const int chain = static_cast<int>(lg % B);
  const int ch = c_lo + static_cast<int>(lg / B);
  const size_t lanes = static_cast<size_t>(kAges) * B;
  const size_t lane = static_cast<size_t>(chain) * kAges + age;
  const Lane<T> q = load_lane(agevec, scal, cst, age, chain, B);

  T y[kCarried];
  const T* src = ckpt + static_cast<size_t>(ch) * kCarried * lanes +
                 static_cast<size_t>(age) * B + chain;
#pragma unroll
  for (int c = 0; c < kCarried; ++c) y[c] = src[c * lanes];
  for (int k = 0; k < kChunk; ++k) {
    const int t = ch * kChunk + k;
    const bool keep = active && t < n_intervals;
    const int r = run_of(t, n_runs, cst.run_start);
    T* dst = ends + end_slot(t, c_lo * kChunk, 0, substeps, lanes, lane);
    advance_day<Tab>(y, q, beff[static_cast<size_t>(r) * B + chain], substeps,
                     cst, [&](int sub, const T (&ye)[kCarried]) {
                       if (!keep) return;
#pragma unroll
                       for (int c = 0; c < kCarried; ++c)
                         dst[(static_cast<size_t>(sub) * kCarried + c) * lanes] = ye[c];
                     });
  }
}

// K3 stage "stages" (regime 1): the stage inputs of every substep and their
// raw force (row 7: the 29 sweeps need not repeat its shuffles), one lane
// group per (chain, day, substep), into ybuf at
// (((t * substeps + sub) * S + i) * 8 + c) * 4B + chain * 4 + age (a dead
// stage's rows are not written; nothing reads them).
template <typename T, typename Tab>
__global__ void __launch_bounds__(kThreads)
sepaihrd_adjoint_stages_kernel(const T* __restrict__ agevec,
                               const T* __restrict__ scal,
                               const T* __restrict__ beff,
                               const T* __restrict__ ckpt,
                               const T* __restrict__ ends, T* __restrict__ ybuf,
                               int B, int substeps, int n_runs, int n_intervals,
                               const Consts<T> cst) {
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long groups = static_cast<long long>(B) * n_intervals * substeps;
  const bool active = (gid >> 2) < groups;
  const long long lg = active ? (gid >> 2) : groups - 1;
  const int age = static_cast<int>(gid & (kAges - 1));
  const int chain = static_cast<int>(lg % B);
  const int sub = static_cast<int>((lg / B) % substeps);
  const int t = static_cast<int>(lg / B / substeps);
  const size_t lanes = static_cast<size_t>(kAges) * B;
  const size_t lane = static_cast<size_t>(chain) * kAges + age;
  const Lane<T> q = load_lane(agevec, scal, cst, age, chain, B);
  const int r = run_of(t, n_runs, cst.run_start);

  T y[kCarried];
  load_start(y, ends, ckpt, t, 0, sub, substeps, lanes, lane, age, chain, B);
  T* dst = ybuf + (static_cast<size_t>(t) * substeps + sub) * Tab::S * kStageRows * lanes + lane;
  stage_inputs<Tab>(y, q, beff[static_cast<size_t>(r) * B + chain], cst,
                     [&](int i, const T (&yi)[kCarried]) {
                       T row[kStageRows];
#pragma unroll
                       for (int c = 0; c < kRhsRows; ++c) row[c] = yi[c];
                       row[kRhsRows] = raw_force(row, q);
                       if (!active) return;
#pragma unroll
                       for (int c = 0; c < kStageRows; ++c)
                         dst[static_cast<size_t>(i * kStageRows + c) * lanes] = row[c];
                     });
}

// K3 stage "chunk" (regime 1): block (chain, chunk) runs the particular
// sweep (lane group 0) and the 28 homogeneous sweeps (lane group 1 + c * 4 +
// age' starts from lam[c] = 1 on age') over the chunk's days. Output:
//   tm   ((chain * n_chunks + chunk) * 67 + row) * 29 + sweep, rows
//        lambda (c * 4 + age), dagevec (28 + p * 4 + age), dscal (60 + p);
//   segb ((chain * n_seg + chunk + run) * 29 + sweep: d(beta) of the days of
//        `run` inside `chunk` (chunk + run numbers these segments in order).
template <typename T, typename Tab>
__global__ void __launch_bounds__(kThreads)
sepaihrd_adjoint_chunk_kernel(const T* __restrict__ agevec,
                              const T* __restrict__ scal,
                              const T* __restrict__ beff,
                              const T* __restrict__ obs,
                              const T* __restrict__ valid,
                              const T* __restrict__ g,
                              const T* __restrict__ ends,
                              const T* __restrict__ ybuf, T* __restrict__ tm,
                              T* __restrict__ segb, int B, int T_obs,
                              int runup_offset, int substeps, int n_runs,
                              int n_intervals, int n_chunks,
                              const Consts<T> cst) {
  // one substep's stage rows, twice: the next substep's are fetched while
  // this one is transposed
  constexpr int kVals = Tab::S * kStageRows * kAges;
  constexpr int kLoads = (kVals + kThreads - 1) / kThreads;
  __shared__ T ysh[2][kVals];
  const int chain = blockIdx.x / n_chunks;
  const int ch = blockIdx.x % n_chunks;
  const int age = threadIdx.x & (kAges - 1);
  const bool active = (threadIdx.x >> 2) < kSweeps;
  const int sweep = active ? (threadIdx.x >> 2) : kSweeps - 1;
  const size_t lanes = static_cast<size_t>(kAges) * B;
  const size_t lane = static_cast<size_t>(chain) * kAges + age;
  const int n_seg = n_chunks + n_runs - 1;
  const Lane<T> q = load_lane(agevec, scal, cst, age, chain, B);
  const Col<T> mc = {cst.M[0][age], cst.M[1][age], cst.M[2][age], cst.M[3][age]};
  const T gll = g[chain];

  T lam[kCarried];
#pragma unroll
  for (int c = 0; c < kCarried; ++c)
    lam[c] = (sweep > 0 && sweep - 1 == c * kAges + age) ? T(1) : T(0);
  T dq[kParams];
#pragma unroll
  for (int p = 0; p < kParams; ++p) dq[p] = T(0);
  T dbeta = T(0);
  const int t_last = min((ch + 1) * kChunk, n_intervals) - 1;
  int rb = run_of(t_last, n_runs, cst.run_start);
  T beta_b = beff[static_cast<size_t>(rb) * B + chain];
  auto flush = [&]() {
    const T tot = age_sum(dbeta);
    if (active && age == 0)
      segb[(static_cast<size_t>(chain) * n_seg + ch + rb) * kSweeps + sweep] = tot;
    dbeta = T(0);
  };

  auto fetch = [&](int t, int sub, T (&v)[kLoads]) {
    const T* src = ybuf + (static_cast<size_t>(t) * substeps + sub) * kVals * B +
                   static_cast<size_t>(chain) * kAges;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int idx = threadIdx.x + l * kThreads;
      if (idx < kVals) v[l] = src[static_cast<size_t>(idx >> 2) * lanes + (idx & (kAges - 1))];
    }
  };
  auto stash = [&](int buf, const T (&v)[kLoads]) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int idx = threadIdx.x + l * kThreads;
      if (idx < kVals) ysh[buf][idx] = v[l];
    }
  };
  T v[kLoads];
  int buf = 0;
  fetch(t_last, substeps - 1, v);
  stash(buf, v);
  __syncthreads();

  for (int t = t_last; t >= ch * kChunk; --t) {
    while (t < cst.run_start[rb]) {         // crossed into the previous run
      flush();
      --rb;
      beta_b = beff[static_cast<size_t>(rb) * B + chain];
    }
    if (sweep == 0) {
      fold_adjoint(lam, ends + end_slot(t, 0, substeps - 1, substeps, lanes, lane),
                   lanes, obs, valid, t, runup_offset, T_obs, age, gll);
    }
    for (int sub = substeps - 1; sub >= 0; --sub) {
      const bool more = sub > 0 || t > ch * kChunk;   // a substep is swept next
      if (more) fetch(sub > 0 ? t : t - 1, sub > 0 ? sub - 1 : substeps - 1, v);
      const T* const ys = ysh[buf];
      substep_vjp<Tab>(
          [&](int i, T (&yi)[kRhsRows], T& lraw) {
#pragma unroll
            for (int c = 0; c < kRhsRows; ++c)
              yi[c] = ys[(i * kStageRows + c) * kAges + age];
            lraw = ys[(i * kStageRows + kRhsRows) * kAges + age];
          },
          lam, dq, dbeta, q, mc, beta_b, cst);
      if (more) stash(buf ^ 1, v);
      __syncthreads();                      // all are done with ysh[buf]
      buf ^= 1;
    }
    // transpose of the reset: the zeroed rows take no cotangent
    lam[7] = T(0);
    lam[8] = T(0);
    lam[9] = T(0);
  }
  flush();
  T dsc[7];
#pragma unroll
  for (int p = 0; p < 7; ++p) dsc[p] = age_sum(dq[kTheta + p]);
  if (!active) return;
  T* out = tm + (static_cast<size_t>(chain) * n_chunks + ch) * kOutRows * kSweeps + sweep;
#pragma unroll
  for (int c = 0; c < kRhsRows; ++c) out[(c * kAges + age) * kSweeps] = lam[c];
#pragma unroll
  for (int p = 0; p < 8; ++p) out[(kSeam + p * kAges + age) * kSweeps] = dq[p];
  if (age == 0) {
#pragma unroll
    for (int p = 0; p < 7; ++p) out[(kSeam + 8 * kAges + p) * kSweeps] = dsc[p];
  }
}

// K3 stage "compose" (regime 1): one block per chain walks the chunks from
// the last to the first. Thread o < 67 owns output row o of the chunk maps
// (lambda rows first), thread 96 + r the d(beta) of run r; each adds its
// row's particular entry and, from the second-last chunk on, the 28
// products with the entering lambda, in float64 whatever T is.
template <typename T>
__global__ void __launch_bounds__(kComposeThreads)
sepaihrd_adjoint_compose_kernel(const T* __restrict__ tm,
                                const T* __restrict__ segb, T* __restrict__ dy0,
                                T* __restrict__ dagevec, T* __restrict__ dscal,
                                T* __restrict__ dbeff, int B, int n_runs,
                                int n_chunks, const Consts<T> cst) {
  __shared__ double lam[kSeam];
  const int chain = blockIdx.x;
  const int o = threadIdx.x;
  const int run = o - 96;
  const int n_seg = n_chunks + n_runs - 1;
  if (o < kSeam) lam[o] = 0.0;
  double acc = 0.0;
  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    __syncthreads();
    const T* row = nullptr;
    if (o < kOutRows) {
      row = tm + ((static_cast<size_t>(chain) * n_chunks + ch) * kOutRows + o) * kSweeps;
    } else if (run >= 0 && run < n_runs && cst.run_start[run] < (ch + 1) * kChunk &&
               cst.run_start[run] + cst.run_count[run] > ch * kChunk) {
      row = segb + (static_cast<size_t>(chain) * n_seg + ch + run) * kSweeps;
    }
    // the last chunk has no entering lambda: its homogeneous columns are
    // not read (they hold the chunk's Jacobian, which can overflow where
    // the gradient does not, as on a stiff row)
    double v = 0.0;
    if (row != nullptr) {
      v = static_cast<double>(row[0]);
      if (ch < n_chunks - 1)
        for (int j = 0; j < kSeam; ++j) v += static_cast<double>(row[1 + j]) * lam[j];
    }
    __syncthreads();
    if (o < kSeam) lam[o] = v; else acc += v;
  }
  const size_t AB = static_cast<size_t>(kAges) * B;
  if (o < kSeam) {                          // dy0 rows S..ICU
    dy0[static_cast<size_t>(o >> 2) * AB + static_cast<size_t>(o & 3) * B + chain] = T(lam[o]);
    // R, D, CumH, CumICU: nothing reads them
    if (o < 4 * kAges)
      dy0[static_cast<size_t>(kRhsRows + (o >> 2)) * AB + static_cast<size_t>(o & 3) * B + chain] = T(0);
  } else if (o < kSeam + 8 * kAges) {
    const int p = (o - kSeam) >> 2, age = (o - kSeam) & 3;
    dagevec[static_cast<size_t>(p) * AB + static_cast<size_t>(age) * B + chain] = T(acc);
  } else if (o < kOutRows) {
    dscal[static_cast<size_t>(o - kSeam - 8 * kAges) * B + chain] = T(acc);
  } else if (run >= 0 && run < n_runs) {
    dbeff[static_cast<size_t>(run) * B + chain] = T(acc);
  }
}

// K3 stage "sweep" (regime 2): one lane group per chain sweeps the chunks
// [c_lo, c_hi) backward from the states `ends` of that wave. `first` marks
// the launch of the last chunks (lambda starts at 0), `last` the one that
// reaches chunk 0 and writes the outputs; between launches lambda's rows
// 0..6, the parameter cotangents and the open run's d(beta) rest in `carry`
// (slot * 4B + lane). Dynamic shared memory: S * 7 values a thread.
template <typename T, typename Tab>
__global__ void __launch_bounds__(kThreads)
sepaihrd_adjoint_sweep_kernel(const T* __restrict__ agevec,
                              const T* __restrict__ scal,
                              const T* __restrict__ beff,
                              const T* __restrict__ obs,
                              const T* __restrict__ valid,
                              const T* __restrict__ ckpt,
                              const T* __restrict__ g, T* __restrict__ dy0,
                              T* __restrict__ dagevec, T* __restrict__ dscal,
                              T* __restrict__ dbeff, const T* __restrict__ ends,
                              T* __restrict__ carry, int B, int T_obs,
                              int runup_offset, int substeps, int n_runs,
                              int n_intervals, int c_lo, int c_hi, int first,
                              int last, const Consts<T> cst) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ysm = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
  const int nt = blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int age = tid & (kAges - 1);
  const bool active = (tid >> 2) < B;
  const int chain = active ? (tid >> 2) : B - 1;
  const size_t lanes = static_cast<size_t>(kAges) * B;
  const size_t lane = static_cast<size_t>(chain) * kAges + age;
  const size_t AB = lanes;
  const size_t at = static_cast<size_t>(age) * B + chain;
  const Lane<T> q = load_lane(agevec, scal, cst, age, chain, B);
  const Col<T> mc = {cst.M[0][age], cst.M[1][age], cst.M[2][age], cst.M[3][age]};
  const T gll = g[chain];
  const int t0 = c_lo * kChunk;
  const int t_last = min(c_hi * kChunk, n_intervals) - 1;

  T lam[kCarried];
  T dq[kParams];
  T dbeta = T(0);
#pragma unroll
  for (int c = 0; c < kCarried; ++c) lam[c] = T(0);
#pragma unroll
  for (int p = 0; p < kParams; ++p) dq[p] = T(0);
  // the run of the day swept last: the one after this wave, if any
  int rb = run_of(first ? t_last : t_last + 1, n_runs, cst.run_start);
  if (!first) {
#pragma unroll
    for (int c = 0; c < kRhsRows; ++c) lam[c] = carry[c * lanes + lane];
#pragma unroll
    for (int p = 0; p < kParams; ++p) dq[p] = carry[(kRhsRows + p) * lanes + lane];
    dbeta = carry[(kRhsRows + kParams) * lanes + lane];
  }
  T beta_b = beff[static_cast<size_t>(rb) * B + chain];

  for (int t = t_last; t >= t0; --t) {
    while (t < cst.run_start[rb]) {         // crossed into the previous run
      const T tot = age_sum(dbeta);
      if (active && age == 0) dbeff[static_cast<size_t>(rb) * B + chain] = tot;
      dbeta = T(0);
      --rb;
      beta_b = beff[static_cast<size_t>(rb) * B + chain];
    }
    fold_adjoint(lam, ends + end_slot(t, t0, substeps - 1, substeps, lanes, lane),
                 lanes, obs, valid, t, runup_offset, T_obs, age, gll);
    for (int sub = substeps - 1; sub >= 0; --sub) {
      T y[kCarried];
      load_start(y, ends, ckpt, t, t0, sub, substeps, lanes, lane, age, chain, B);
      stage_inputs<Tab>(y, q, beta_b, cst, [&](int i, const T (&yi)[kCarried]) {
#pragma unroll
        for (int c = 0; c < kRhsRows; ++c) ysm[(i * kRhsRows + c) * nt] = yi[c];
      });
      substep_vjp<Tab>(
          [&](int i, T (&yi)[kRhsRows], T& lraw) {
#pragma unroll
            for (int c = 0; c < kRhsRows; ++c) yi[c] = ysm[(i * kRhsRows + c) * nt];
            lraw = raw_force(yi, q);
          },
          lam, dq, dbeta, q, mc, beta_b, cst);
    }
    // transpose of the reset: the zeroed rows take no cotangent
    lam[7] = T(0);
    lam[8] = T(0);
    lam[9] = T(0);
  }
  if (!last) {
    if (!active) return;
#pragma unroll
    for (int c = 0; c < kRhsRows; ++c) carry[c * lanes + lane] = lam[c];
#pragma unroll
    for (int p = 0; p < kParams; ++p) carry[(kRhsRows + p) * lanes + lane] = dq[p];
    carry[(kRhsRows + kParams) * lanes + lane] = dbeta;
    return;
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

// K3's scratch, in values of T, for one regime: where each stage's buffer
// starts and how long they are together.
struct ScratchPlan {
  long long ends, ybuf, tm, segb, carry, total;
};

ScratchPlan plan_scratch(int regime, int B, int substeps, int n_stages,
                         int n_intervals, int n_runs, int n_chunks,
                         int wave_chunks) {
  const long long lanes = static_cast<long long>(kAges) * B;
  ScratchPlan p = {};
  const int held = regime == 1 ? n_chunks : wave_chunks;
  long long at = static_cast<long long>(held) * kChunk * substeps * kCarried * lanes;
  if (regime == 1) {
    p.ybuf = at;
    at += static_cast<long long>(n_intervals) * substeps * n_stages * kStageRows * lanes;
    p.tm = at;
    at += static_cast<long long>(B) * n_chunks * kOutRows * kSweeps;
    p.segb = at;
    at += static_cast<long long>(B) * (n_chunks + n_runs - 1) * kSweeps;
  } else {
    p.carry = at;
    at += kCarry * lanes;
  }
  p.total = at;
  return p;
}

// blocks of `threads` for `total` threads: small grids take one warp a
// block, so that a latency-bound stage spreads over the SMs
inline int block_size(long long total, int sm_count) {
  return total >= static_cast<long long>(sm_count) * kThreads ? kThreads : 32;
}

// The sweep's stage inputs take more dynamic shared memory than a kernel
// gets unasked (50 KB a block in f64 dopri5): ask once per instantiation
// and device, not at every launch.
template <typename T, typename Tab>
cudaError_t allow_sweep_smem() {
  constexpr int kMaxDevices = 64;
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      sepaihrd_adjoint_sweep_kernel<T, Tab>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(static_cast<size_t>(Tab::S) * kRhsRows * kThreads * sizeof(T)));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = true;
  return err;
}

template <typename T>
int launch_bwd(const T* agevec, const T* scal, const T* beff, const T* obs,
               const T* valid, const T* ckpt, const T* g, T* dy0, T* dagevec,
               T* dscal, T* dbeff, T* scratch, long long scratch_len, int B,
               int T_obs, int runup_offset, int substeps, int tableau,
               const double* a_host, const double* b_host,
               const double* M_host, int n_runs, const int* run_start,
               const int* run_count, int n_chunks, int regime, int wave_chunks,
               int sm_count, int* n_launched, void* stream) {
  Consts<T> c;
  int n_intervals = 0;
  if (!check<T>(B, T_obs, runup_offset, substeps, n_runs, run_start, run_count,
                n_chunks, &n_intervals) ||
      (regime != 1 && regime != 2) || wave_chunks < 1 || sm_count < 1 ||
      !make_consts(c, tableau, a_host, b_host, M_host, n_runs, run_start,
                   run_count)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_stages = tableau_stages(tableau);
  const ScratchPlan p = plan_scratch(regime, B, substeps, n_stages, n_intervals,
                                     n_runs, n_chunks, wave_chunks);
  if (scratch_len < p.total) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* const ends = scratch + p.ends;
  int launched = 0;
  auto grid = [](long long total, int block) {
    return static_cast<unsigned>((total + block - 1) / block);
  };
  auto days = [&](int c_lo, int n_wave) -> int {
    const long long total = static_cast<long long>(kAges) * B * n_wave;
    const int block = block_size(total, sm_count);
#define MMIDV1_LAUNCH(TAB)                                                    \
  sepaihrd_adjoint_days_kernel<T, TAB><<<grid(total, block), block, 0, s>>>(  \
      agevec, scal, beff, ckpt, ends, B, substeps, n_runs, n_intervals, c_lo, \
      n_wave, c)
    SEPAIHRD_DISPATCH_TABLEAU(tableau, MMIDV1_LAUNCH)
#undef MMIDV1_LAUNCH
    ++launched;
    return static_cast<int>(cudaGetLastError());
  };
  cudaError_t err = cudaSuccess;
  if (regime == 1) {
    if (int rc = days(0, n_chunks)) return rc;
    {
      const long long total =
          static_cast<long long>(kAges) * B * n_intervals * substeps;
      const int block = block_size(total, sm_count);
#define MMIDV1_LAUNCH(TAB)                                                      \
  sepaihrd_adjoint_stages_kernel<T, TAB><<<grid(total, block), block, 0, s>>>(  \
      agevec, scal, beff, ckpt, ends, scratch + p.ybuf, B, substeps, n_runs,    \
      n_intervals, c)
      SEPAIHRD_DISPATCH_TABLEAU(tableau, MMIDV1_LAUNCH)
#undef MMIDV1_LAUNCH
      ++launched;
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    {
      const unsigned blocks = static_cast<unsigned>(B) * n_chunks;
#define MMIDV1_LAUNCH(TAB)                                                    \
  sepaihrd_adjoint_chunk_kernel<T, TAB><<<blocks, kThreads, 0, s>>>(          \
      agevec, scal, beff, obs, valid, g, ends, scratch + p.ybuf,              \
      scratch + p.tm, scratch + p.segb, B, T_obs, runup_offset, substeps,     \
      n_runs, n_intervals, n_chunks, c)
      SEPAIHRD_DISPATCH_TABLEAU(tableau, MMIDV1_LAUNCH)
#undef MMIDV1_LAUNCH
      ++launched;
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    sepaihrd_adjoint_compose_kernel<T><<<B, kComposeThreads, 0, s>>>(
        scratch + p.tm, scratch + p.segb, dy0, dagevec, dscal, dbeff, B, n_runs,
        n_chunks, c);
    ++launched;
    err = cudaGetLastError();
  } else {
    const long long total = static_cast<long long>(kAges) * B;
    const unsigned blocks = grid(total, kThreads);
    const size_t smem = static_cast<size_t>(n_stages) * kRhsRows * kThreads * sizeof(T);
    for (int c_hi = n_chunks; c_hi > 0 && err == cudaSuccess; c_hi -= wave_chunks) {
      const int c_lo = c_hi > wave_chunks ? c_hi - wave_chunks : 0;
      if (int rc = days(c_lo, c_hi - c_lo)) return rc;
#define MMIDV1_LAUNCH(TAB)                                                    \
  {                                                                           \
    err = allow_sweep_smem<T, TAB>();                                         \
    if (err != cudaSuccess) return static_cast<int>(err);                     \
    sepaihrd_adjoint_sweep_kernel<T, TAB><<<blocks, kThreads, smem, s>>>(     \
        agevec, scal, beff, obs, valid, ckpt, g, dy0, dagevec, dscal, dbeff,  \
        ends, scratch + p.carry, B, T_obs, runup_offset, substeps, n_runs,    \
        n_intervals, c_lo, c_hi, c_hi == n_chunks, c_lo == 0, c);             \
  }
      SEPAIHRD_DISPATCH_TABLEAU(tableau, MMIDV1_LAUNCH)
#undef MMIDV1_LAUNCH
      ++launched;
      err = cudaGetLastError();
    }
  }
  if (n_launched != nullptr) *n_launched = launched;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// K2. regime 1: split (few chains); 2: wide. tableau: the id of
// sepaihrd_tableaus.cuh, as for K1.
int sepaihrd_fwd_ckpt_f32(const float* y0, const float* agevec,
                          const float* scal, const float* beff,
                          const float* obs, const float* valid, float* out,
                          float* ckpt, int B, int T_obs, int runup_offset,
                          int substeps, int tableau, const double* a_host,
                          const double* b_host, const double* M_host,
                          int n_runs, const int* run_start,
                          const int* run_count, int n_chunks, int regime,
                          void* stream) {
  return sepaihrd::launch_forward<float, true>(
      y0, agevec, scal, beff, obs, valid, out, ckpt, B, T_obs, runup_offset,
      substeps, tableau, a_host, b_host, M_host, n_runs, run_start, run_count,
      n_chunks, regime, stream);
}

int sepaihrd_fwd_ckpt_f64(const double* y0, const double* agevec,
                          const double* scal, const double* beff,
                          const double* obs, const double* valid, double* out,
                          double* ckpt, int B, int T_obs, int runup_offset,
                          int substeps, int tableau, const double* a_host,
                          const double* b_host, const double* M_host,
                          int n_runs, const int* run_start,
                          const int* run_count, int n_chunks, int regime,
                          void* stream) {
  return sepaihrd::launch_forward<double, true>(
      y0, agevec, scal, beff, obs, valid, out, ckpt, B, T_obs, runup_offset,
      substeps, tableau, a_host, b_host, M_host, n_runs, run_start, run_count,
      n_chunks, regime, stream);
}

// K3. regime 1: days, stages, chunk, compose over all chunks at once;
// regime 2: days + sweep per wave of `wave_chunks` chunks, last wave first.
// `scratch` holds at least sepaihrd_adjoint_scratch_len(...) values;
// *n_launched gets the number of kernels launched.
int sepaihrd_adjoint_f32(const float* agevec, const float* scal,
                         const float* beff, const float* obs,
                         const float* valid, const float* ckpt, const float* g,
                         float* dy0, float* dagevec, float* dscal,
                         float* dbeff, float* scratch, long long scratch_len,
                         int B, int T_obs, int runup_offset, int substeps,
                         int tableau, const double* a_host,
                         const double* b_host, const double* M_host,
                         int n_runs, const int* run_start,
                         const int* run_count, int n_chunks, int regime,
                         int wave_chunks, int sm_count, int* n_launched,
                         void* stream) {
  return launch_bwd<float>(agevec, scal, beff, obs, valid, ckpt, g, dy0,
                           dagevec, dscal, dbeff, scratch, scratch_len, B,
                           T_obs, runup_offset, substeps, tableau, a_host,
                           b_host, M_host, n_runs, run_start, run_count,
                           n_chunks, regime, wave_chunks, sm_count,
                           n_launched, stream);
}

int sepaihrd_adjoint_f64(const double* agevec, const double* scal,
                         const double* beff, const double* obs,
                         const double* valid, const double* ckpt,
                         const double* g, double* dy0, double* dagevec,
                         double* dscal, double* dbeff, double* scratch,
                         long long scratch_len, int B, int T_obs,
                         int runup_offset, int substeps, int tableau,
                         const double* a_host, const double* b_host,
                         const double* M_host, int n_runs,
                         const int* run_start, const int* run_count,
                         int n_chunks, int regime, int wave_chunks,
                         int sm_count, int* n_launched, void* stream) {
  return launch_bwd<double>(agevec, scal, beff, obs, valid, ckpt, g, dy0,
                            dagevec, dscal, dbeff, scratch, scratch_len, B,
                            T_obs, runup_offset, substeps, tableau, a_host,
                            b_host, M_host, n_runs, run_start, run_count,
                            n_chunks, regime, wave_chunks, sm_count,
                            n_launched, stream);
}

long long sepaihrd_adjoint_scratch_len(int regime, int B, int substeps,
                                       int n_stages, int n_intervals,
                                       int n_runs, int wave_chunks) {
  return plan_scratch(regime, B, substeps, n_stages, n_intervals, n_runs,
                      (n_intervals + kChunk - 1) / kChunk, wave_chunks)
      .total;
}

const char* sepaihrd_adjoint_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
