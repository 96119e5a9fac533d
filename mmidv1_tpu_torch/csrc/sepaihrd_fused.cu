// Fused SEPAIHRD objective for NVIDIA Hopper (sm_90a): the whole fixed-grid
// explicit-RK solve plus the 3-stream Poisson log-likelihood fold, one
// log-likelihood per chain, in one launch.
//
// Replaces the Pallas TPU kernel mmidv1_tpu/ops/sepaihrd_pallas.py
// `fused_objective` (body `_make_kernel`, RHS `_rhs`, RK `make_interval_fn`).
// It computes exactly what that kernel computes, for any tableau whose
// coefficients the caller passes (FSAL honoured):
//   - per daily interval: D/CumH/CumICU reset to 0, `substeps` RK steps of
//     h = 1/substeps with beta*kappa*scaling frozen per static schedule run;
//   - incidence max(day value, 0) + 1e-10 for deaths, hospital and ICU
//     admissions; term = sum over streams and ages of
//     valid * (obs * log(inc) - inc), Kahan-summed over the observed days;
//     interval t folds observation row j = t + 1 - runup_offset, and only
//     rows 0 <= j < T_obs count (the masked edge run at the run-up boundary);
//   - row 0 (inc = 1e-10 everywhere) is added when runup_offset == 0.
// R is absorbing, unread and unobserved, so it is not carried.
// Infeasible / NaN / Inf masking stays with the caller.
//
// What bounds it: arithmetic, not memory. Per chain and evaluation at Spain
// size (325 intervals), one dopri5 substep is 6 fresh RHS evaluations (FSAL)
// of 41 flop per age lane (contact matvec 7, infectious pressure 4, lambda 2,
// flows 11, derivatives 17) plus 20 stage axpys and 5 update axpys over 10
// compartments at 2 flop: 246 + 500 = 746 flop per lane, x 4 lanes = ~3.0e3
// flop per chain-substep. At 4 substeps that is ~3.9e6 flop per chain
// (cash_karp at 3 substeps: 6 RHS + 15 + 4 axpys = 626 flop per lane,
// ~2.4e6 per chain), plus ~18 flop and 3 logs a lane per observed day. At
// B = 8192 chains that is ~3.2e10 flop (dopri5@4): ~0.48 ms at the H100 SXM's
// 67 TFLOP/s FP32 non-tensor peak, ~0.95 ms at its 34 TFLOP/s FP64 peak.
// Inputs are (44 + 32 + 7 + 7) values per chain (~5.9 MB at 8192 chains in
// f64), so memory time is ~2 us. `op_count` in ops/sepaihrd_fused.py computes
// the count for any tableau from the same per-item costs.
//
// Design against that bound: one thread per (chain, age) in groups of four
// lanes (sepaihrd_common.cuh), so a chain's 10 carried compartments and its
// stage vectors live in registers (one thread per chain would need 7 x 40
// stage values and spill); the 4x4 contact matvec is four __shfl_sync reads
// inside the lane group and the per-day sum over ages two __shfl_xor_sync
// steps, so no shared memory and no block barrier sits in the loop. The
// stage count is a template parameter so the stage loops unroll and the
// stage vectors stay in registers; the coefficients, contact matrix and schedule runs ride in the
// kernel's parameter space (constant bank). Chains sit last in every input
// ((11,4,B), (8,4,B), (7,B), (n_runs,B)) so the four lanes of neighbouring
// chains read neighbouring addresses. Observation tables are read through the
// read-only cache. Threads past the last chain mirror the last chain so every
// shuffle has a full warp; they store nothing.
//
// Numerics: built without --use_fast_math; `log` is the accurate log. nvcc
// contracts a*b+c into FMA, so the kernel and its plain PyTorch version
// differ by rounding only. The Kahan compensation has no multiply, so
// contraction cannot fold it away, and nvcc does not reassociate floating
// point adds without fast-math.

#include "sepaihrd_common.cuh"

namespace {

using namespace sepaihrd;

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
sepaihrd_fused_kernel(const T* __restrict__ y0, const T* __restrict__ agevec,
                      const T* __restrict__ scal, const T* __restrict__ beff,
                      const T* __restrict__ obs, const T* __restrict__ valid,
                      T* __restrict__ out, int B, int T_obs, int runup_offset,
                      int substeps, int fsal, int n_runs, const Consts<T> cst) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int age = tid & (kAges - 1);
  const bool active = (tid >> 2) < B;
  const int chain = active ? (tid >> 2) : B - 1;
  const size_t AB = static_cast<size_t>(kAges) * B;
  const size_t at = static_cast<size_t>(age) * B + chain;
  const T eps = T(1e-10);
  const Lane<T> q = load_lane(agevec, scal, cst, age, chain, B);

  // carried rows of the (11, 4, B) initial state: R (row 7) is dropped
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

template <typename T>
int launch(const T* y0, const T* agevec, const T* scal, const T* beff,
           const T* obs, const T* valid, T* out, int B, int T_obs,
           int runup_offset, int substeps, int n_stages, int fsal,
           const double* a_host, const double* b_host, const double* M_host,
           int n_runs, const int* run_start, const int* run_count,
           void* stream) {
  Consts<T> c;
  if (B < 1 || T_obs < 1 || substeps < 1 ||
      !make_consts(c, n_stages, a_host, b_host, M_host, n_runs, run_start,
                   run_count)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long threads_total = static_cast<long long>(kAges) * B;
  const int blocks = static_cast<int>((threads_total + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MMIDV1_LAUNCH(NS)                                                     \
  sepaihrd_fused_kernel<T, NS><<<blocks, kThreads, 0, s>>>(                   \
      y0, agevec, scal, beff, obs, valid, out, B, T_obs, runup_offset,        \
      substeps, fsal, n_runs, c)
  SEPAIHRD_DISPATCH_STAGES(n_stages, MMIDV1_LAUNCH)
#undef MMIDV1_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sepaihrd_fused_f32(const float* y0, const float* agevec, const float* scal,
                       const float* beff, const float* obs, const float* valid,
                       float* out, int B, int T_obs, int runup_offset,
                       int substeps, int n_stages, int fsal,
                       const double* a_host, const double* b_host,
                       const double* M_host, int n_runs, const int* run_start,
                       const int* run_count, void* stream) {
  return launch<float>(y0, agevec, scal, beff, obs, valid, out, B, T_obs,
                       runup_offset, substeps, n_stages, fsal, a_host, b_host,
                       M_host, n_runs, run_start, run_count, stream);
}

int sepaihrd_fused_f64(const double* y0, const double* agevec,
                       const double* scal, const double* beff,
                       const double* obs, const double* valid, double* out,
                       int B, int T_obs, int runup_offset, int substeps,
                       int n_stages, int fsal, const double* a_host,
                       const double* b_host, const double* M_host, int n_runs,
                       const int* run_start, const int* run_count,
                       void* stream) {
  return launch<double>(y0, agevec, scal, beff, obs, valid, out, B, T_obs,
                        runup_offset, substeps, n_stages, fsal, a_host, b_host,
                        M_host, n_runs, run_start, run_count, stream);
}

const char* sepaihrd_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
