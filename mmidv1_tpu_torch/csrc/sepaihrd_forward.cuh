// The forward recurrence of the SEPAIHRD kernels, K1 and K2, for NVIDIA
// Hopper (sm_90a): the fixed-grid RK solve of every chain plus the 3-stream
// Poisson fold, and with CKPT the pre-reset day-start state every kChunk
// days. One source for both: K1 (sepaihrd_fused.cu) instantiates it without
// the checkpoint stores, K2 (sepaihrd_adjoint.cu) with them.
//
// Replaces the Pallas TPU kernels mmidv1_tpu/ops/sepaihrd_pallas.py
// `fused_objective` (K1) and mmidv1_tpu/ops/sepaihrd_adjoint.py `_fwd_call`
// (K2). Per chain:
//   - per daily interval: D/CumH/CumICU reset to 0, `substeps` RK steps of
//     h = 1/substeps with beta*kappa*scaling frozen per static schedule run
//     (rk4, cash_karp, rkf45, dopri5 or fehlberg78, each its own
//     instantiation; FSAL honoured);
//   - incidence max(day value, 0) + 1e-10 for deaths, hospital and ICU
//     admissions; term = sum over streams and ages of
//     valid * (obs * log(inc) - inc), Kahan-summed over the observed days;
//     interval t folds observation row j = t + 1 - runup_offset, and only
//     rows 0 <= j < T_obs count (the masked edge run at the run-up boundary);
//   - row 0 (inc = 1e-10 everywhere) is added when runup_offset == 0;
//   - CKPT: the state at the start of every day t with t % kChunk == 0,
//     before the reset, into ckpt (n_chunks, 10, 4, B), chains last.
// R is absorbing, unread and unobserved, so it is not carried. Infeasible /
// NaN / Inf masking stays with the caller.
//
// Two bounds. The roofline: arithmetic, not memory. Per chain at Spain size
// (325 intervals) one dopri5 substep is 6 fresh RHS evaluations (FSAL) of 41
// flop per age lane plus 20 stage and 5 update axpys over 10 rows at 2 flop:
// 746 flop a lane, ~3.9e6 flop a chain at 4 substeps; at B = 8192 that is
// ~0.48 ms at the H100 SXM's 67 TFLOP/s FP32 non-tensor peak and ~0.95 ms at
// its 34 TFLOP/s FP64 peak, against ~2 us of memory time (`op_count` in
// ops/sepaihrd_fused.py counts any tableau). The chain: the solve is a
// recurrence of 325 x (1 + 4 x 6) = 8125 RK stages that each need the one
// before, and at the chain counts the samplers run (64 to 1024) the card is
// mostly empty and each warp waits on itself. A row's derivative reads the
// stage inputs of a few rows only, so the recurrence is a graph over
// (row, stage), and what bounds it is that graph's longest mean cycle, not
// the length of one stage's code. Its edges, in arithmetic instructions
// (rhs_up in sepaihrd_common.cuh, a*b+c contracted):
//   u_c(i+1) <- k_c(i)    the last axpy of the stage input: 1 FMA, any row
//   lam(i)   <- uP, uA(i) add, FMA, multiply (the infectious pressure), the
//                         shuffle round of the contact matvec (its four
//                         reads are independent), its 4 chained terms, a *,
//                         beta *, the 2 instructions of max(x, 0): 11 and a
//                         shuffle; from uI(i) 10 (the add is off its way)
//   kE(i)    <- lam(i)    lam * S, fSE - fEP: 2
//   kP(i)    <- uE(i)     sigma * E, fEP - fPo: 2
//   kA(i)    <- uP(i)     gp * P, p * fPo, fPA - gA * A: 3
//   kI(i)    <- uP(i)     gp * P, p * fPo, fPo - fPA, fPI - (...): 4
// kP, kA and kI do not read the lam of their own stage: lam(i) feeds only
// kS(i) and kE(i). So the loop from lam to lam spans two stages,
//   lam(i) -> kE(i) -> uE(i+1) -> kP(i+1) -> uP(i+2) -> lam(i+2),
// 2 + 1 + 2 + 1 + 11 = 17 arithmetic instructions and one shuffle. The ways
// round through A or I (uP(i+2) -> kA or kI(i+2) -> uA or uI(i+3) ->
// lam(i+3)) are 21 and a shuffle over three stages, and a row's own loop
// (u -> k -> u) is 3 to 5 a stage: all shorter a stage. The bound is the
// first: 8.5 arithmetic instructions and half a shuffle a stage, 46 cycles in
// float32 and 80 in float64 at 4 / 8 cycles an arithmetic instruction and 24
// a shuffle (latencies from published tables of the architecture, not
// measured here). The extra FMA where a substep's update precedes the next
// stage input is not counted: it is a lower bound. `chain_cycles` in
// ops/sepaihrd_fused.py holds the count; chip_smoke.py turns it into the
// chain bound with the SM clock it reads. What the kernels take above it is
// issue, not chain: the split regime's producer still issues 54 instructions
// a stage from one warp, one a cycle at best.
//
// What the design does about the chain, in both regimes: nothing stands
// between a stage and the next but the chain itself. The tableau's zero
// pattern is a type (sepaihrd_common.cuh): a zero coefficient emits no
// instruction, so there is no test of an entry at run time (a branch every
// few FMAs, which cuts a stage into blocks the scheduler cannot move
// instructions across, or a predicate and a register move a row) and no
// FMA by zero either (dopri5's three zeros, fehlberg78's 29 of 91). A stage
// is one straight run of instructions in which the chain's latencies hide
// most of the instruction stream, and the kernels skip a zero entry as the
// Pallas kernel and the plain version do.
//
// Two regimes, picked by the wrappers from the chain count and the card's SMs
// (`choose_forward_regime`; the timed crossover is the same in both types):
//   wide   (many chains; throughput-bound) one thread per (chain, age) in
//          groups of four lanes, all 10 carried rows and the stage vectors in
//          registers, no shared memory and no barrier in the loop; ~70
//          instructions a stage in float32 dopri5.
//   split  (few chains; bound by the chain) the cascade split over two warps
//          of a block. The producer warp integrates S E P A I alone (five
//          rows and k[S][5]): fewer axpys, a shorter RHS and none of the
//          fold on the warp that sets the pace (~54 instructions a stage).
//          For every stage it writes the stage input of I, the one value the
//          other rows need, into a ring in shared memory, one slot a substep
//          (S values a lane, kRing slots). The consumer warp, lane for lane
//          the same (chain, age), integrates H ICU D CumH CumICU from the
//          ring with the same tableau (its own FSAL stage carried), resets
//          D / CumH / CumICU each day, folds the Poisson rows (accurate
//          log), sums over ages, Kahan-sums and writes out[chain]; with CKPT
//          each warp stores its own five rows. The hand-over is a pair of
//          mbarriers a slot (full: the producer's lane 0 arrives after a
//          __syncwarp; empty: the consumer's), waited on by parity with
//          mbarrier.try_wait, which parks the warp instead of spinning on
//          the producer's scheduler slots; the producer waits only when the
//          ring is full. A block is one such warp pair of 8 chains (2 and 4
//          pairs a block were timed and are no faster, PERF.md), so 64
//          chains spread over 8 SMs, and up to two blocks an SM every warp
//          has a scheduler to itself. Every row is computed by the same
//          operations in the same order as in the wide regime (rhs_up and
//          rhs_down are the halves of its rhs, and in the rows behind I
//          which product fuses into which sum is written out in
//          sepaihrd_common.cuh, not left to nvcc's contraction), so the two
//          agree to the bit.
// In both, the tableau's type is a template parameter so the stage loops
// unroll and the stage vectors stay in registers; coefficients, contact matrix and
// schedule ride in the kernel's parameter space (constant bank); chains sit
// last in every input so neighbouring lanes read neighbouring addresses;
// lane groups past the last chain mirror it, so every shuffle has a full
// warp, and store nothing.
//
// Numerics: built without --use_fast_math; `log` is the accurate log. nvcc
// contracts rhs_up's and the axpys' a*b+c into FMAs; rhs_down and the
// Poisson term say which products fuse (mul_rn / add_rn / fma_rn). So the kernels
// and their plain PyTorch version, which fuses none, differ by rounding
// only. The Kahan compensation has no multiply, and nvcc does not
// reassociate floating point adds without fast-math.

#pragma once

#include <cstdint>

#include "sepaihrd_common.cuh"

namespace sepaihrd {

constexpr int kRing = 4;          // substep slots of a producer's ring
constexpr int kWarp = 32;

enum Regime { kSplit = 1, kWide = 2 };

// ---- the Poisson fold, Kahan-summed ----------------------------------------

template <typename T>
struct Fold {
  T ll, comp;
};

template <typename T>
__device__ __forceinline__ Fold<T> fold_start(const T* __restrict__ obs,
                                              const T* __restrict__ valid,
                                              int runup_offset, int age) {
  Fold<T> f = {T(0), T(0)};
  const T eps = T(1e-10);
  if (runup_offset == 0) {
    f.ll = f.ll + age_sum(poisson_row(obs, valid, 0, age, eps, eps, eps));
  }
  return f;
}

// day t's incidence (the day-end D, CumH, CumICU) against observation row j
template <typename T>
__device__ __forceinline__ void fold_day(Fold<T>& f, const T* __restrict__ obs,
                                         const T* __restrict__ valid, int t,
                                         int runup_offset, int T_obs, int age,
                                         T d, T h, T i) {
  const int j = t + 1 - runup_offset;
  if (j >= 0 && j < T_obs) {
    const T eps = T(1e-10);
    const T term = age_sum(poisson_row(obs, valid, j, age, relu(d) + eps,
                                       relu(h) + eps, relu(i) + eps));
    const T contrib = term - f.comp;
    const T ll_new = f.ll + contrib;
    f.comp = (ll_new - f.ll) - contrib;
    f.ll = ll_new;
  }
}

// the row of the (11, 4, B) state that carried compartment c is
__device__ __forceinline__ int state_row(int c) { return c < 7 ? c : c + 1; }

// ---- the wide regime -------------------------------------------------------

template <typename T, typename Tab, bool CKPT>
__global__ void __launch_bounds__(kThreads)
sepaihrd_forward_wide_kernel(const T* __restrict__ y0,
                             const T* __restrict__ agevec,
                             const T* __restrict__ scal,
                             const T* __restrict__ beff,
                             const T* __restrict__ obs,
                             const T* __restrict__ valid, T* __restrict__ out,
                             T* __restrict__ ckpt, int B, int T_obs,
                             int runup_offset, int substeps, int n_runs,
                             const Consts<T> cst) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int age = tid & (kAges - 1);
  const bool active = (tid >> 2) < B;
  const int chain = active ? (tid >> 2) : B - 1;
  const size_t AB = static_cast<size_t>(kAges) * B;
  const size_t at = static_cast<size_t>(age) * B + chain;
  const Lane<T> q = load_lane(agevec, scal, cst, age, chain, B);

  T y[kCarried];
#pragma unroll
  for (int c = 0; c < kCarried; ++c) y[c] = y0[state_row(c) * AB + at];

  Fold<T> f = fold_start(obs, valid, runup_offset, age);
  for (int r = 0; r < n_runs; ++r) {
    const T beta = beff[static_cast<size_t>(r) * B + chain];
    const int t_end = cst.run_start[r] + cst.run_count[r];
    for (int t = cst.run_start[r]; t < t_end; ++t) {
      if (CKPT && t % kChunk == 0 && active) {
        // the PRE-reset day-start state: K3 applies the same reset
        T* dst = ckpt + static_cast<size_t>(t / kChunk) * kCarried * AB + at;
#pragma unroll
        for (int c = 0; c < kCarried; ++c) dst[c * AB] = y[c];
      }
      advance_day<Tab>(y, q, beta, substeps, cst);
      fold_day(f, obs, valid, t, runup_offset, T_obs, age, y[7], y[8], y[9]);
    }
  }
  if (active && age == 0) out[chain] = f.ll;
}

// ---- the split regime ------------------------------------------------------

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the phase of parity `parity` is complete; try_wait parks the warp for
// a while by itself, so the loop costs next to nothing
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        "  .reg .pred p;\n"
        "  mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "  selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A block is one warp pair: warp 0 the producer, warp 1 the consumer, lane
// for lane the same (chain, age). Its shared memory is static: kRing x (full,
// empty) mbarriers and a ring of kRing slots x S values x 32 lanes, 13.4 KB
// at most (fehlberg78 in float64), whatever `substeps` is.
template <typename T, typename Tab, bool CKPT>
__global__ void __launch_bounds__(2 * kWarp)
sepaihrd_forward_split_kernel(const T* __restrict__ y0,
                              const T* __restrict__ agevec,
                              const T* __restrict__ scal,
                              const T* __restrict__ beff,
                              const T* __restrict__ obs,
                              const T* __restrict__ valid, T* __restrict__ out,
                              T* __restrict__ ckpt, int B, int T_obs,
                              int runup_offset, int substeps, int n_runs,
                              const Consts<T> cst) {
  constexpr int S = Tab::S;
  __shared__ uint64_t bars[kRing * 2];
  __shared__ T ring_slots[kRing * S * kWarp];
  const int lane = threadIdx.x % kWarp;
  const bool producer = threadIdx.x < kWarp;

  if (threadIdx.x == 0) {
    for (int b = 0; b < kRing * 2; ++b) mbar_init(shared_addr(bars + b), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // slot s: full at full0 + 16 s, empty 8 bytes behind it
  const unsigned full0 = shared_addr(bars);
  T* const ring = ring_slots + lane;

  const int gl = blockIdx.x * kWarp + lane;                   // (chain, age)
  const int age = gl & (kAges - 1);
  const bool active = (gl >> 2) < B;
  const int chain = active ? (gl >> 2) : B - 1;
  const size_t AB = static_cast<size_t>(kAges) * B;
  const size_t at = static_cast<size_t>(age) * B + chain;
  const Lane<T> q = load_lane(agevec, scal, cst, age, chain, B);
  unsigned n = 0;                           // substeps handed over so far

  if (producer) {
    T u[kUp], k[S][kUp];
#pragma unroll
    for (int c = 0; c < kUp; ++c) u[c] = y0[c * AB + at];
    for (int r = 0; r < n_runs; ++r) {
      const T beta = beff[static_cast<size_t>(r) * B + chain];
      const int t_end = cst.run_start[r] + cst.run_count[r];
      for (int t = cst.run_start[r]; t < t_end; ++t) {
        if (CKPT && t % kChunk == 0 && active) {
          T* dst = ckpt + static_cast<size_t>(t / kChunk) * kCarried * AB + at;
#pragma unroll
          for (int c = 0; c < kUp; ++c) dst[c * AB] = u[c];
        }
        for (int sub = 0; sub < substeps; ++sub, ++n) {
          const unsigned slot = n % kRing;
          mbar_wait(full0 + 16 * slot + 8, ((n / kRing) & 1) ^ 1);
          T* const dst = ring + slot * S * kWarp;
          rk_substep<Tab>(u, k, sub == 0 || !Tab::fsal, cst,
                          [&](int i, const T (&ui)[kUp], T (&ki)[kUp]) {
                            dst[i * kWarp] = ui[4];
                            rhs_up(ui, ki, q, beta);
                          });
          __syncwarp();
          if (lane == 0) mbar_arrive(full0 + 16 * slot);
        }
      }
    }
    return;
  }

  T z[kDown], k[S][kDown];
#pragma unroll
  for (int c = 0; c < kDown; ++c) z[c] = y0[state_row(kUp + c) * AB + at];
  Fold<T> f = fold_start(obs, valid, runup_offset, age);
  for (int r = 0; r < n_runs; ++r) {
    const int t_end = cst.run_start[r] + cst.run_count[r];
    for (int t = cst.run_start[r]; t < t_end; ++t) {
      if (CKPT && t % kChunk == 0 && active) {
        T* dst = ckpt + (static_cast<size_t>(t / kChunk) * kCarried + kUp) * AB + at;
#pragma unroll
        for (int c = 0; c < kDown; ++c) dst[c * AB] = z[c];
      }
      z[2] = T(0);
      z[3] = T(0);
      z[4] = T(0);
      for (int sub = 0; sub < substeps; ++sub, ++n) {
        const unsigned slot = n % kRing;
        mbar_wait(full0 + 16 * slot, (n / kRing) & 1);
        const T* const src = ring + slot * S * kWarp;
        rk_substep<Tab>(z, k, sub == 0 || !Tab::fsal, cst,
                        [&](int i, const T (&zi)[kDown], T (&ki)[kDown]) {
                          rhs_down(src[i * kWarp], zi, ki, q);
                        });
        __syncwarp();
        if (lane == 0) mbar_arrive(full0 + 16 * slot + 8);
      }
      fold_day(f, obs, valid, t, runup_offset, T_obs, age, z[2], z[3], z[4]);
    }
  }
  if (active && age == 0) out[chain] = f.ll;
}

// ---- launch ----------------------------------------------------------------

// K1 (CKPT false, ckpt unused) or K2 in `regime`, for the tableau with id
// `tableau`. cudaErrorInvalidValue for what does not fit.
template <typename T, bool CKPT>
int launch_forward(const T* y0, const T* agevec, const T* scal, const T* beff,
                   const T* obs, const T* valid, T* out, T* ckpt, int B,
                   int T_obs, int runup_offset, int substeps, int tableau,
                   const double* a_host, const double* b_host,
                   const double* M_host, int n_runs, const int* run_start,
                   const int* run_count, int n_chunks, int regime,
                   void* stream) {
  Consts<T> c;
  if (B < 1 || T_obs < 1 || substeps < 1 || runup_offset < 0 ||
      (regime != kSplit && regime != kWide) ||
      !make_consts(c, tableau, a_host, b_host, M_host, n_runs, run_start,
                   run_count)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int n_intervals = 0;
  for (int r = 0; r < n_runs; ++r) {
    if (run_start[r] != n_intervals || run_count[r] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    n_intervals += run_count[r];
  }
  if (CKPT && n_chunks != (n_intervals + kChunk - 1) / kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long lanes = static_cast<long long>(kAges) * B;
  if (regime == kWide) {
    const int blocks = static_cast<int>((lanes + kThreads - 1) / kThreads);
#define MMIDV1_LAUNCH(TAB)                                                    \
  sepaihrd_forward_wide_kernel<T, TAB, CKPT><<<blocks, kThreads, 0, s>>>(     \
      y0, agevec, scal, beff, obs, valid, out, ckpt, B, T_obs, runup_offset,  \
      substeps, n_runs, c)
    SEPAIHRD_DISPATCH_TABLEAU(tableau, MMIDV1_LAUNCH)
#undef MMIDV1_LAUNCH
  } else {
    const int blocks = static_cast<int>((lanes + kWarp - 1) / kWarp);
#define MMIDV1_LAUNCH(TAB)                                                    \
  sepaihrd_forward_split_kernel<T, TAB, CKPT><<<blocks, 2 * kWarp, 0, s>>>(   \
      y0, agevec, scal, beff, obs, valid, out, ckpt, B, T_obs, runup_offset,  \
      substeps, n_runs, c)
    SEPAIHRD_DISPATCH_TABLEAU(tableau, MMIDV1_LAUNCH)
#undef MMIDV1_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sepaihrd
