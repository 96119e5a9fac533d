// K1, the fused SEPAIHRD objective for NVIDIA Hopper (sm_90a): the whole
// fixed-grid explicit-RK solve plus the 3-stream Poisson log-likelihood fold,
// one log-likelihood per chain, in one launch.
//
// Replaces the Pallas TPU kernel mmidv1_tpu/ops/sepaihrd_pallas.py
// `fused_objective` (body `_make_kernel`, RHS `_rhs`, RK `make_interval_fn`).
// The kernels are in sepaihrd_forward.cuh, which K2 shares: its header says
// what they compute, their two bounds (the roofline, by arithmetic, and the
// dependency chain of 8125 RK stages, which is what binds at the chain
// counts the samplers run) and what the two regimes, split and wide, do
// about them. This file is their instantiation without checkpoint stores
// and the C interface.

#include "sepaihrd_forward.cuh"

extern "C" {

// regime 1: split (few chains); 2: wide. tableau: the id of
// sepaihrd_tableaus.cuh (ops/_build.py KERNEL_TABLEAUS), a_host (S x S) and
// b_host (S) its coefficients times h.
int sepaihrd_fused_f32(const float* y0, const float* agevec, const float* scal,
                       const float* beff, const float* obs, const float* valid,
                       float* out, int B, int T_obs, int runup_offset,
                       int substeps, int tableau, const double* a_host,
                       const double* b_host, const double* M_host, int n_runs,
                       const int* run_start, const int* run_count, int regime,
                       void* stream) {
  return sepaihrd::launch_forward<float, false>(
      y0, agevec, scal, beff, obs, valid, out, nullptr, B, T_obs, runup_offset,
      substeps, tableau, a_host, b_host, M_host, n_runs, run_start, run_count,
      0, regime, stream);
}

int sepaihrd_fused_f64(const double* y0, const double* agevec,
                       const double* scal, const double* beff,
                       const double* obs, const double* valid, double* out,
                       int B, int T_obs, int runup_offset, int substeps,
                       int tableau, const double* a_host, const double* b_host,
                       const double* M_host, int n_runs, const int* run_start,
                       const int* run_count, int regime, void* stream) {
  return sepaihrd::launch_forward<double, false>(
      y0, agevec, scal, beff, obs, valid, out, nullptr, B, T_obs, runup_offset,
      substeps, tableau, a_host, b_host, M_host, n_runs, run_start, run_count,
      0, regime, stream);
}

const char* sepaihrd_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
