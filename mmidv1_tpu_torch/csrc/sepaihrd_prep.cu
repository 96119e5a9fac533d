// The fused objective's prep and mask for NVIDIA Hopper (sm_90a): theta ->
// K1's inputs in one launch, and K1's log-likelihoods -> the objective's
// values in another.
//
// Replaces no Pallas kernel: the JAX package leaves `shared_prep`
// (mmidv1_tpu/ops/sepaihrd_pallas.py) to XLA's fusion. In PyTorch the same
// work is about a hundred small kernels (constrain, the per-field scatter,
// the initial state, the stacks of the pack, the mask), each of which moves
// a few KB and is bound by its launch. These two kernels do it in two.
//
// What bounds them: bytes. At 8192 chains in float32 the prep reads the
// (B, d) thetas and writes y0 (11, 4, B), agevec (8, 4, B), scal (7, B),
// beff (n_runs, B) and the infeasible flags, about 3 MB, so about 1 us at
// 3.35 TB/s; the launch takes longer than that, and what is left is the
// latency of each value's chain of dependent reads (table, theta, the
// constraint's constants, the fmod). So the design is one launch for all
// of it with one thread an output element: every chain's ~90 values are
// computed side by side, none after another, each thread reading what its
// element needs and writing it once, chains adjacent (coalesced) as K1
// reads them.
//
// The gather table (ops/sepaihrd_fused.FusedPrep.table, built once per
// objective and held on the device as float64, so a CUDA graph replay
// copies nothing) says for each "slot" (a field element of the parameters:
// a_j, h_infec_j, ..., theta, sigma, ..., the contact scaling, the
// multipliers, run-up, the schedule values) whether it is a theta column
// (after the constraint) or the base value, and carries the constants of
// the derived inputs. Its format is defined in ops/sepaihrd_fused.py alone:
// the generated header sepaihrd_prep_layout.cuh gives the slots read by
// position and each section's index in ``head``, the sections' offsets in
// the table, which the kernel takes by value. One kernel serves every
// parameter space.
//
// Every value is computed with the operations of the PyTorch version
// (ParameterSpace.reflect / clamp, models/sepaihrd.initial_state_for_params,
// FusedPrep's pack) in their order and rounding, each a separately rounded
// IEEE operation written with the __*_rn intrinsics (no contraction into an
// fma; no --use_fast_math), so that its outputs equal theirs bit for bit on
// the card. T is the objective's dtype, TC the constraint's (the promotion
// of T and the space's dtype).

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

#include "sepaihrd_prep_layout.cuh"  // generated by ops/_build.py

namespace sepaihrd_prep {

constexpr int kThreads = 128;
constexpr int kReflect = 1;        // mode: 0 clamp, 1 reflect
// the slots of agevec's fields by age, then scal's
constexpr int kAgeSlots = kAgeFields * kAges;
static_assert(kScal0 == kAgeSlots, "agevec's slots come first");
// rows E..D of the state (S E P A I H ICU R D CumH CumICU) carry the
// multipliers; their sum below is torch.sum's order over 8 rows
static_assert(kMults == 8 && kRows == kMults + 3, "rows E..D");
// a chain's outputs but beff's: y0, agevec, scal and the infeasible flag
constexpr int kOutputs = kRows * kAges + kAgeSlots + kScalSlots + 1;

// each table section's offset, by its index (kSrc, kBase, ...)
struct Head {
  int at[kSections];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// torch.maximum / torch.minimum on the card: a NaN operand is returned as
// it is, else ::max / ::min
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return ::max(a, b);
}
template <typename T>
__device__ __forceinline__ T minimum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return ::min(a, b);
}

// torch.remainder on the card for floating types: the sign of the divisor
template <typename T>
__device__ __forceinline__ T remainder(T a, T b) {
  T mod = ::fmod(a, b);
  if ((mod != T(0)) && ((b < T(0)) != (mod < T(0)))) mod = add(mod, b);
  return mod;
}

// Theta column c constrained in TC (ParameterSpace.reflect / clamp) and
// cast to T as ParameterSpace.apply casts it.
template <typename T, typename TC, int MODE>
__device__ __forceinline__ T constrain(const double* __restrict__ tab,
                                       const Head& H, T theta, int c) {
  const TC x = static_cast<TC>(theta);
  const TC lo = static_cast<TC>(__ldg(tab + H.at[kLo] + c));
  const TC hi = static_cast<TC>(__ldg(tab + H.at[kHi] + c));
  if (MODE != kReflect) return static_cast<T>(minimum(maximum(x, lo), hi));
  const TC w = static_cast<TC>(__ldg(tab + H.at[kW] + c));
  const TC w2 = static_cast<TC>(__ldg(tab + H.at[kW2] + c));
  TC y = remainder(sub(x, lo), w2);
  y = y < TC(0) ? add(y, w2) : y;
  const TC refl = y <= w ? add(lo, y) : sub(hi, sub(y, w));
  return static_cast<T>(__ldg(tab + H.at[kDeg] + c) != 0.0 ? lo : refl);
}

// One thread an output element: thread t writes element t / B (y0's 44,
// then agevec's 32, scal's 7, beff's R, then the infeasible flag) of chain
// t % B, so a warp's chains are adjacent (coalesced stores, one branch a
// warp) and no thread constrains more than the ten thetas an element
// needs (the S row and the flag: the eight multipliers and run-up).
template <typename T, typename TC, int MODE>
__global__ void __launch_bounds__(kThreads)
prep_kernel(const T* __restrict__ thetas, const double* __restrict__ tab,
            const Head H, T* __restrict__ y0, T* __restrict__ agevec,
            T* __restrict__ scal, T* __restrict__ beff,
            bool* __restrict__ infeasible, int B, int d, int R) {
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<size_t>(kOutputs + R) * B) return;
  int o = static_cast<int>(t / B);
  const int b = static_cast<int>(t - static_cast<size_t>(o) * B);
  const T* row = thetas + static_cast<size_t>(b) * d;
  // slot s: its theta column constrained, or its base value
  auto slot = [&](int s) {
    const int c = static_cast<int>(__ldg(tab + H.at[kSrc] + s));
    return c < 0 ? static_cast<T>(__ldg(tab + H.at[kBase] + s))
                 : constrain<T, TC, MODE>(tab, H, row[c], c);
  };
  auto constant = [&](int i) { return static_cast<T>(__ldg(tab + i)); };

  if (o < kRows * kAges || o == kOutputs + R - 1) {
    // y0 (11, 4, B) and the infeasible flag (initial_state_for_params)
    const bool seeded = (slot(kRunup) > T(0)) && (slot(kSeed) > T(0));
    const int k = o / kAges, j = o % kAges;
    if (seeded) {
      // run-up seeding: E = seed * N / sum(N), S = N - E, the rest 0; the
      // sum of rows E..D is E itself
      const T seed = slot(kSeed);
      auto E = [&](int a) { return mul(seed, constant(H.at[kFrac] + a)); };
      if (o < kRows * kAges) {
        y0[t] = k == 0 ? sub(constant(H.at[kN] + j), E(j)) : k == 1 ? E(j) : T(0);
      } else {
        bool bad = false;
#pragma unroll
        for (int a = 0; a < kAges; ++a) bad |= E(a) > constant(H.at[kN] + a);
        infeasible[b] = bad;
      }
      return;
    }
    // the multipliers on the data-inferred state: row k of E..D scaled by
    // its multiplier, CumH and CumICU as they are, S = N - the sum of rows
    // E..D, summed as torch.sum over that dimension sums on the card: four
    // accumulators from 0, row i and row i + 4 in each, then combined in
    // order
    auto scaled = [&](int r, int a) {
      return mul(constant(H.at[kY0] + r * kAges + a), slot(kMult + r - 1));
    };
    auto sum = [&](int a) {
      T acc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i] = add(add(T(0), scaled(1 + i, a)), scaled(5 + i, a));
      return add(add(add(acc[0], acc[1]), acc[2]), acc[3]);
    };
    if (o == kOutputs + R - 1) {
      bool bad = false;
      for (int a = 0; a < kAges; ++a) bad |= sum(a) > constant(H.at[kN] + a);
      infeasible[b] = bad;
    } else if (k == 0) {
      y0[t] = sub(constant(H.at[kN] + j), sum(j));
    } else {
      y0[t] = k <= kMults ? scaled(k, j) : constant(H.at[kY0] + o);
    }
    return;
  }
  o -= kRows * kAges;
  if (o < kAgeSlots) {
    // agevec (8, 4, B): the fields by age, h_infec times 1/N
    T v = slot(o);
    if (o / kAges == kHInfec) v = mul(v, constant(H.at[kInvN] + o % kAges));
    agevec[static_cast<size_t>(o) * B + b] = v;
    return;
  }
  o -= kAgeSlots;
  if (o < kScalSlots) {
    scal[static_cast<size_t>(o) * B + b] = slot(kScal0 + o);
    return;
  }
  // beff (R, B): (beta * scaling) * kappa of schedule run o
  o -= kScalSlots;
  const int sb = static_cast<int>(__ldg(tab + H.at[kRunBeta] + o));
  const int sk = static_cast<int>(__ldg(tab + H.at[kRunKappa] + o));
  beff[static_cast<size_t>(o) * B + b] =
      mul(mul(slot(sb), slot(kScaling)), slot(sk));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mask_kernel(const T* __restrict__ ll, const bool* __restrict__ infeasible,
            T* __restrict__ out, int B, T lowest) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const T v = ll[b];
  const bool nan = v != v, inf = v == T(INFINITY) || v == -T(INFINITY);
  out[b] = (infeasible[b] || nan || inf) ? lowest : v;
}

template <typename T, typename TC>
int launch_prep(const T* thetas, const double* table, const int* head, T* y0,
                T* agevec, T* scal, T* beff, bool* infeasible, int B, int d,
                int R, int mode, void* stream) {
  Head H;
  for (int i = 0; i < kSections; ++i) H.at[i] = head[i];
  if (B < 1 || d < 1 || R < 1 || H.at[kBase] - H.at[kSrc] < kFixedSlots ||
      (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t threads = static_cast<size_t>(kOutputs + R) * B;
  const dim3 blocks(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  auto s = static_cast<cudaStream_t>(stream);
  if (mode == kReflect)
    prep_kernel<T, TC, 1><<<blocks, kThreads, 0, s>>>(
        thetas, table, H, y0, agevec, scal, beff, infeasible, B, d, R);
  else
    prep_kernel<T, TC, 0><<<blocks, kThreads, 0, s>>>(
        thetas, table, H, y0, agevec, scal, beff, infeasible, B, d, R);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mask(const T* ll, const bool* infeasible, T* out, int B, T lowest,
                void* stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 blocks((B + kThreads - 1) / kThreads);
  mask_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ll, infeasible, out, B, lowest);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sepaihrd_prep

extern "C" {

// T float32, the constraint in float32 (a float32 space)
int sepaihrd_prep_f32(const float* thetas, const double* table,
                      const int* head, float* y0, float* agevec, float* scal,
                      float* beff, bool* infeasible, int B, int d, int R,
                      int mode, void* stream) {
  return sepaihrd_prep::launch_prep<float, float>(
      thetas, table, head, y0, agevec, scal, beff, infeasible, B, d, R, mode,
      stream);
}

// T float64 (the constraint in float64 whatever the space's dtype)
int sepaihrd_prep_f64(const double* thetas, const double* table,
                      const int* head, double* y0, double* agevec,
                      double* scal, double* beff, bool* infeasible, int B,
                      int d, int R, int mode, void* stream) {
  return sepaihrd_prep::launch_prep<double, double>(
      thetas, table, head, y0, agevec, scal, beff, infeasible, B, d, R, mode,
      stream);
}

int sepaihrd_mask_f32(const float* ll, const bool* infeasible, float* out,
                      int B, void* stream) {
  return sepaihrd_prep::launch_mask<float>(ll, infeasible, out, B, -FLT_MAX,
                                           stream);
}

int sepaihrd_mask_f64(const double* ll, const bool* infeasible, double* out,
                      int B, void* stream) {
  return sepaihrd_prep::launch_mask<double>(ll, infeasible, out, B, -DBL_MAX,
                                            stream);
}

const char* sepaihrd_prep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
