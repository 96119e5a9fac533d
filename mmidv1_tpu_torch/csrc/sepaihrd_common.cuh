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

#include <type_traits>
#include <utility>

// One type per tableau (TabRk4, TabCashKarp, TabRkf45, TabDopri5,
// TabFehlberg78): its stage count S, fsal, and the zero pattern of a and b
// (a_row(i), b_bits). Generated from ode/tableaus.py into the build
// directory at every build (ops/_build.py), so it is no second copy of the
// tables; the coefficient values reach the kernels at run time in Consts.
#include "sepaihrd_tableaus.cuh"

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

// The stage count of the tableau with this id; 0 for an unknown id.
inline int tableau_stages(int tableau) {
#define SEPAIHRD_STAGES_CASE(I, TAB, A) \
  if (tableau == I) return TAB::S;
  SEPAIHRD_TABLEAUS(SEPAIHRD_STAGES_CASE, 0)
#undef SEPAIHRD_STAGES_CASE
  return 0;
}

// Consts from the host arrays (a: S x S, b: S of the tableau with this id);
// false for an unknown tableau or a size out of range.
template <typename T>
bool make_consts(Consts<T>& c, int tableau, const double* a_host,
                 const double* b_host, const double* M_host, int n_runs,
                 const int* run_start, const int* run_count) {
  const int n_stages = tableau_stages(tableau);
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

// Rounded operations that nvcc never fuses (mul_rn, add_rn, sub_rn) and an
// explicit fused multiply-add (fma_rn). rhs_down and the Poisson term are
// written with them, so which products fuse into which sums is fixed by
// the source. Left to nvcc's contraction, the rows behind I fused
// differently in the split regime's consumer warp and in the wide regime's
// thread, once the tableau's zero pattern left some of their stage
// derivatives dead, and the two regimes no longer agreed to the bit. rhs_up
// and the axpys are left to nvcc: their rows agree, and written out they
// made the split regime's float32 producer up to 51 % slower on an H100.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

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
  const T fIH = mul_rn(q.h, I);
  const T fHICU = mul_rn(q.icu, z[0]);
  const T dHrow = mul_rn(q.dH, z[0]);
  const T dICUrow = mul_rn(q.dICU, z[1]);

  dz[0] = sub_rn(fIH, add_rn(fma_rn(q.gH, z[0], dHrow), fHICU));
  dz[1] = sub_rn(fHICU, fma_rn(q.gICU, z[1], dICUrow));
  dz[2] = fma_rn(q.dcomm, I, add_rn(dHrow, dICUrow));   // + fIDc
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
    term = add_rn(term, fma_rn(o, log(incs[s]), -mul_rn(v, incs[s])));
  }
  return term;
}

// ---- the tableau's zero pattern, at compile time ----------------------------
//
// The rule is the Pallas kernels' (mmidv1_tpu/ops/sepaihrd_pallas.py, the
// `if a_tab[i, j] != 0.0` of make_interval_fn, and the jax.vjp of its
// substep in mmidv1_tpu/ops/sepaihrd_adjoint.py) and the plain versions':
// a zero coefficient contributes nothing. Here the zero pattern is part of
// the tableau's type, so a zero a_ij or b_i emits no instruction at all: no
// FMA, no compare, no predicate, and a stage is one straight run of
// instructions. So a non-finite k behind a zero (reachable near overflow:
// dopri5's discarded k[6] on a day's last substep) poisons nothing, in K1,
// K2 and K3 alike, and K2's checkpoints and K3's re-integration follow one
// rule. A stage that nothing reads (no b_i and no a_ji, j > i) is dead: it
// is neither evaluated (unless FSAL carries it) nor transposed, as
// jax.vjp gives it a symbolic zero cotangent. The values h*a_ij and h*b_i
// stay run-time constants (Consts), rounded on the host as the Pallas
// kernel rounds them.

template <typename Tab>
__host__ __device__ constexpr bool a_nz(int i, int j) {
  return (Tab::a_row(i) >> j) & 1u;
}

template <typename Tab>
__host__ __device__ constexpr bool b_nz(int i) {
  return (Tab::b_bits >> i) & 1u;
}

// stage i's derivative is read by a later stage's input
template <typename Tab>
__host__ __device__ constexpr bool feeds(int i) {
  for (int j = i + 1; j < Tab::S; ++j)
    if (a_nz<Tab>(j, i)) return true;
  return false;
}

// stage i's derivative is read at all (by a later stage or the update)
template <typename Tab>
__host__ __device__ constexpr bool live(int i) {
  return b_nz<Tab>(i) || feeds<Tab>(i);
}

// stage i is evaluated by a forward substep: live, or carried by FSAL
template <typename Tab>
__host__ __device__ constexpr bool evaluated(int i) {
  return live<Tab>(i) || (Tab::fsal && i == Tab::S - 1);
}

// f(integral_constant<int, I>) for I = 0 .. N-1 in order (DOWN: N-1 .. 0):
// the index is a constant expression in f, so `if constexpr` on the zero
// pattern drops a zero entry's code whatever the unroller does.
template <bool DOWN, int N, typename F, int... Is>
__device__ __forceinline__ void static_for_seq(F& f,
                                               std::integer_sequence<int, Is...>) {
  (f(std::integral_constant<int, DOWN ? N - 1 - Is : Is>{}), ...);
}

template <int N, bool DOWN = false, typename F>
__device__ __forceinline__ void static_for(F f) {
  static_for_seq<DOWN, N>(f, std::make_integer_sequence<int, N>{});
}

// y += a * k over R rows
template <typename T, int R>
__device__ __forceinline__ void axpy_rows(T (&y)[R], T a, const T (&k)[R]) {
#pragma unroll
  for (int c = 0; c < R; ++c) y[c] = y[c] + a * k[c];
}

// the stage input of stage I, yi = y + sum_{j<I, a_Ij != 0} a_Ij k_j, over
// R rows
template <typename Tab, int I, typename T, int R>
__device__ __forceinline__ void stage_input(const T (&y)[R],
                                            const T (&k)[Tab::S][R],
                                            T (&yi)[R], const Consts<T>& cst) {
#pragma unroll
  for (int c = 0; c < R; ++c) yi[c] = y[c];
  static_for<I>([&](auto J) {
    constexpr int j = decltype(J)::value;
    if constexpr (a_nz<Tab>(I, j)) axpy_rows(yi, cst.a[I][j], k[j]);
  });
}

// One RK step of R rows in place. `stage(i, yi, ki)` writes the derivative
// ki at the stage input yi. The first stage is evaluated when `fresh`, else
// it is the last stage of the step before (FSAL), which k still holds.
template <typename Tab, typename T, int R, typename Stage>
__device__ __forceinline__ void rk_substep(T (&y)[R], T (&k)[Tab::S][R],
                                           bool fresh, const Consts<T>& cst,
                                           Stage stage) {
  if (fresh) {
    stage(0, y, k[0]);
  } else {
#pragma unroll
    for (int c = 0; c < R; ++c) k[0][c] = k[Tab::S - 1][c];
  }
  static_for<Tab::S - 1>([&](auto M) {
    constexpr int i = decltype(M)::value + 1;
    if constexpr (evaluated<Tab>(i)) {
      T yi[R];
      stage_input<Tab, i>(y, k, yi, cst);
      stage(i, yi, k[i]);
    }
  });
  static_for<Tab::S>([&](auto I) {
    constexpr int i = decltype(I)::value;
    if constexpr (b_nz<Tab>(i)) axpy_rows(y, cst.b[i], k[i]);
  });
}

// One daily interval in place: D/CumH/CumICU reset to 0 (the day-end value
// is then the day's incidence), then `substeps` RK steps of h = 1/substeps
// with beta frozen; FSAL tableaus carry the last stage into the next substep.
// `after_substep(sub, y)` sees the state after each substep.
template <typename Tab, typename T, typename Hook>
__device__ __forceinline__ void advance_day(T (&y)[kCarried], const Lane<T>& q,
                                            T beta, int substeps,
                                            const Consts<T>& cst,
                                            Hook after_substep) {
  T k[Tab::S][kCarried];
  y[7] = T(0);
  y[8] = T(0);
  y[9] = T(0);
  for (int sub = 0; sub < substeps; ++sub) {
    rk_substep<Tab>(y, k, sub == 0 || !Tab::fsal, cst,
                    [&](int, const T (&yi)[kCarried], T (&ki)[kCarried]) {
                      rhs(yi, ki, q, beta);
                    });
    after_substep(sub, y);
  }
}

template <typename Tab, typename T>
__device__ __forceinline__ void advance_day(T (&y)[kCarried], const Lane<T>& q,
                                            T beta, int substeps,
                                            const Consts<T>& cst) {
  advance_day<Tab>(y, q, beta, substeps, cst,
                   [](int, const T (&)[kCarried]) {});
}

// Launch a kernel templated on the tableau's type for the tableau id of the
// C interface: LAUNCH(TabX) in the case of TabX's id, and
// cudaErrorInvalidValue from the enclosing function for an unknown id.
#define SEPAIHRD_TABLEAU_CASE(I, TAB, LAUNCH) \
  case I:                                     \
    LAUNCH(TAB);                              \
    break;
#define SEPAIHRD_DISPATCH_TABLEAU(tableau, LAUNCH)             \
  switch (tableau) {                                           \
    SEPAIHRD_TABLEAUS(SEPAIHRD_TABLEAU_CASE, LAUNCH)           \
    default: return static_cast<int>(cudaErrorInvalidValue);   \
  }

}  // namespace sepaihrd
