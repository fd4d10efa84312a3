// Linear Safe Corridor planes: for every (agent, obstacle, segment) the
// separating normal of the relative control-point hull and its right-hand
// sides, in one launch.
//
// Replaces no Pallas kernel: on the TPU the JAX package leaves
// planner/constraints.py::lsc_planes (and ops/hull.py's enumeration) to
// XLA, which fuses it.  The port ran it as ~360 PyTorch launches a call
// (ops/lsc_planes.py::lsc_planes_plain, the body of
// planner/constraints.py::lsc_planes before this kernel), each over a
// (hulls x subsets) tensor; this kernel computes the same function with
// one thread a hull and everything in registers.
//
// The function, the plain version's, op for op:
//   * the pair's downwash (constraints.pair_downwash) and the relative
//     control points rel_i = init_i * s - obs_i * s, s = (1, 1, 1 / dw);
//   * ops/hull.py::_closest_point_enum with max_support 3: every subset
//     of 1, 2 and 3 of the K points, in itertools.combinations order, its
//     bordered min-norm system (Gram matrix, relative ridge, Cholesky,
//     G w = 1, lam = w / sum w), the feasibility test, the clamped and
//     renormalised weights, the candidate and its squared norm; the first
//     least d2 among the feasible candidates (torch.argmin: the first NaN
//     if any, the first candidate when none is feasible), non-finite
//     components zeroed; for K > 3 the interior test in residual form with
//     its dtype's tolerance; the normal, +x where the distance is <= eps;
//   * the margin d_i = (r + e_i) / 2, e_i = rel_i . n, the guard band
//     min(guard, s0 / 2) clamped at 0 (guard_margin > 0), the slack
//     branch's RSFC margin, the normal's z divided by dw, and
//     rhs_i = d_i + obs_i . n.
// Bit for bit with those PyTorch ops on the card: each product, sum,
// quotient and square root is one correctly rounded operation
// (__f*_rn / __d*_rn, so nvcc contracts nothing into an FMA), in the
// plain version's order, with aten's CUDA semantics where they are not
// the plain arithmetic:
//   * Python's sum() starts from 0: ((0 + a) + b) + c (0 + -0 is +0);
//   * aten's .sum(-1) over the 3-axis splits the axis over two lanes of
//     its reduce kernel, (x0 + x2) + x1, each lane starting from 0;
//   * x / k by a Python number k is x * (1 / k), the reciprocal taken in
//     the working type (aten's div_true_kernel_cuda for a CPU scalar);
//     1.0 / x is reciprocal(x) * 1.0;
//   * clamp keeps NaN and otherwise takes fmax / fmin;
//   * a Python float scalar is rounded to the working type first.
// The plain version stays the CPU path and the tests' yardstick
// (tests/test_torch_cuda.py, chip_smoke.py).
//
// What bounds it on an H100: operations.  At random1024's (1024, 32, 5, 6)
// the call reads and writes 18.4 MB once (5.5 us at 3.35 TB/s) and does
// ~3,900 correctly rounded operations a hull, 0.64 G in all (9.5 us at
// 67 TFLOP/s with a division counted as one); at K = 6 a hull solves
// 6 + 15 + 20 = 41 systems, ~490 divisions and 97 square roots, each a
// sequence of instructions with a slow path, so the instructions are
// many times the operations.
//
// Design: one thread a hull, its K relative points and the running best
// candidate in registers (K is a template parameter, 1 to 8); nothing
// goes through shared memory, and the loads are each hull's own 2 x 72
// contiguous bytes.  The subset loops stay rolled, each subset's points
// fetched from registers by selects, so the code holds one copy of each
// size's system: with every subset unrolled the build took 66 s instead
// of 46 and random1024's call 0.190 ms instead of 0.175 (PERF.md §6).
// ptxas: 72 registers at float K = 6 (28 B spilled), 158 at double.
// Blocks of kThreads = 64 spread forest20's 2,000 hulls over 32 SMs;
// random1024's 163,840 fill the card many times over.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (lsc_planner_tpu_torch/ops/_build.py).
// Interface: plain C, pointers to contiguous device memory, the CUDA
// stream as an opaque pointer; each entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;

template <typename T> struct R;
template <> struct R<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float sqrt(float a) {
    return __fsqrt_rn(a);
  }
  static __device__ __forceinline__ float max(float a, float b) {
    return fmaxf(a, b);
  }
  static __device__ __forceinline__ float min(float a, float b) {
    return fminf(a, b);
  }
  // -tol of the interior test, the Python float cast to the dtype
  static constexpr float kNegTol = static_cast<float>(-3e-4);
};
template <> struct R<double> {
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ double sqrt(double a) {
    return __dsqrt_rn(a);
  }
  static __device__ __forceinline__ double max(double a, double b) {
    return fmax(a, b);
  }
  static __device__ __forceinline__ double min(double a, double b) {
    return fmin(a, b);
  }
  static constexpr double kNegTol = -1e-6;
};

// torch.clamp(v, min=lo) and torch.clamp(v, lo, hi): NaN stays
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) {
  return isnan(v) ? v : R<T>::max(v, lo);
}
template <typename T>
__device__ __forceinline__ T clamp(T v, T lo, T hi) {
  return isnan(v) ? v : R<T>::min(R<T>::max(v, lo), hi);
}

// Python's sum() of three terms (start 0)
template <typename T>
__device__ __forceinline__ T psum3(T a, T b, T c) {
  using r = R<T>;
  return r::add(r::add(r::add(T(0), a), b), c);
}

// aten's .sum(-1) over a contiguous axis of 3 on the card: lanes 0 and 1
// of the reduce kernel take {x0, x2} and {x1}, each from 0
template <typename T>
__device__ __forceinline__ T asum3(T x0, T x1, T x2) {
  using r = R<T>;
  return r::add(r::add(r::add(T(0), x0), r::add(T(0), x2)),
                r::add(T(0), x1));
}

// ops/hull.py::_solve_subsets for one subset of S points c: the
// candidate (non-finite components zeroed, as _closest_point_enum does)
// and its d2, +inf when infeasible
template <typename T, int S>
__device__ __forceinline__ void solve_subset(const T (&c)[S][3], T cand[3],
                                             T& d2) {
  using r = R<T>;
  T G[S][S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int j = i; j < S; ++j) {
      G[i][j] = psum3(r::mul(c[i][0], c[j][0]), r::mul(c[i][1], c[j][1]),
                      r::mul(c[i][2], c[j][2]));
      G[j][i] = G[i][j];
    }
  }
  // relative ridge: (sum of the diagonal) / S, a division by a Python
  // int, so a product with 1 / S
  T diag_sum = T(0);
#pragma unroll
  for (int i = 0; i < S; ++i) diag_sum = r::add(diag_sum, G[i][i]);
  constexpr T inv_s = T(1) / T(S);
  const T scale = r::mul(diag_sum, inv_s);
  const T ridge = r::add(r::mul(scale, T(1e-7)), T(1e-30));
#pragma unroll
  for (int i = 0; i < S; ++i) G[i][i] = r::add(G[i][i], ridge);

  T L[S][S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    T s = G[j][j];
#pragma unroll
    for (int p = 0; p < j; ++p) s = r::sub(s, r::mul(L[j][p], L[j][p]));
    const T diag = r::sqrt(clamp_min(s, T(1e-30)));
    L[j][j] = diag;
    const T inv = r::mul(r::div(T(1), diag), T(1));
#pragma unroll
    for (int i = j + 1; i < S; ++i) {
      T s2 = G[i][j];
#pragma unroll
      for (int p = 0; p < j; ++p) s2 = r::sub(s2, r::mul(L[i][p], L[j][p]));
      L[i][j] = r::mul(s2, inv);
    }
  }
  // G w = 1, lam = w / sum(w)
  T y[S], w[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    T s = T(1);
#pragma unroll
    for (int p = 0; p < i; ++p) s = r::sub(s, r::mul(L[i][p], y[p]));
    y[i] = r::div(s, L[i][i]);
  }
#pragma unroll
  for (int i = S - 1; i >= 0; --i) {
    T s = y[i];
#pragma unroll
    for (int p = i + 1; p < S; ++p) s = r::sub(s, r::mul(L[p][i], w[p]));
    w[i] = r::div(s, L[i][i]);
  }
  T denom = T(0);
#pragma unroll
  for (int i = 0; i < S; ++i) denom = r::add(denom, w[i]);
  T lam[S];
  bool feasible = true;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    lam[i] = r::div(w[i], denom);
    feasible = feasible && (lam[i] > T(-1e-7)) && isfinite(lam[i]);
  }
  T lam_sum = T(0);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    lam[i] = clamp_min(lam[i], T(0));
    lam_sum = r::add(lam_sum, lam[i]);
  }
  lam_sum = clamp_min(lam_sum, T(1e-12));
#pragma unroll
  for (int i = 0; i < S; ++i) lam[i] = r::div(lam[i], lam_sum);
  T sq = T(0);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    T v = T(0);
#pragma unroll
    for (int j = 0; j < S; ++j) v = r::add(v, r::mul(lam[j], c[j][d]));
    sq = r::add(sq, r::mul(v, v));
    cand[d] = isfinite(v) ? v : T(0);
  }
  d2 = feasible ? sq : T(INFINITY);
}

// the running torch.argmin over the candidates in order: the first NaN,
// else the first least (the first candidate when none is feasible)
template <typename T>
__device__ __forceinline__ void keep_first_min(const T cand[3], T d2,
                                               bool first, T best[3],
                                               T& best_d2) {
  const bool take = first || (isnan(d2) ? !isnan(best_d2)
                                        : (!isnan(best_d2) && d2 < best_d2));
  if (take) {
    best_d2 = d2;
#pragma unroll
    for (int d = 0; d < 3; ++d) best[d] = cand[d];
  }
}

// point i of the hull's K points held in registers: a chain of selects,
// not a run-time index into an array (which would go to local memory)
template <typename T, int K>
__device__ __forceinline__ void pick(const T (&p)[K][3], int i, T out[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    T v = p[0][d];
#pragma unroll
    for (int k = 1; k < K; ++k) v = i == k ? p[k][d] : v;
    out[d] = v;
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
lsc_planes_kernel(const T* __restrict__ init_traj,
                  const T* __restrict__ obs_pred,
                  const T* __restrict__ agent_radius,
                  const T* __restrict__ agent_downwash,
                  const T* __restrict__ obs_radius,
                  const T* __restrict__ obs_downwash,
                  const bool* __restrict__ obs_is_agent,
                  const bool* __restrict__ slack_flags,
                  const T* __restrict__ obs_pred_sizes, T guard,
                  bool use_guard, T* __restrict__ normal_out,
                  T* __restrict__ rhs_out, long long hulls, int O, int M) {
  using r = R<T>;
  const long long h = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (h >= hulls) return;
  const long long no = h / M;              // (agent, obstacle)
  const int m = static_cast<int>(h - no * M);
  const long long n = no / O;

  // constraints.pair_downwash
  const T ar = agent_radius[n], adw = agent_downwash[n];
  const T orad = obs_radius[no], odw = obs_downwash[no];
  const bool is_agent = obs_is_agent[no];
  const T rsum = r::add(ar, orad);
  const T dw = is_agent
      ? r::div(r::add(r::mul(adw, ar), r::mul(odw, orad)), rsum)
      : r::div(r::add(ar, r::mul(odw, orad)), rsum);
  const T sz = r::mul(r::div(T(1), dw), T(1));

  const T* ip = init_traj + (n * M + m) * (K * 3);
  const T* op = obs_pred + h * (K * 3);
  T p[K][3];
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const T s = d == 2 ? sz : T(1);
      p[i][d] = r::sub(r::mul(ip[3 * i + d], s), r::mul(op[3 * i + d], s));
    }
  }

  // ops/hull.py::_closest_point_enum, max_support 3: the subsets in
  // itertools.combinations order, sizes 1, 2, 3; the loops stay rolled
  // (one copy of each size's system in the code)
  T best[3] = {T(0), T(0), T(0)};
  T best_d2 = T(0);
#pragma unroll 1
  for (int a = 0; a < K; ++a) {
    T c[1][3], cand[3], d2;
    pick(p, a, c[0]);
    solve_subset<T, 1>(c, cand, d2);
    keep_first_min(cand, d2, a == 0, best, best_d2);
  }
#pragma unroll 1
  for (int a = 0; a < K - 1; ++a) {
#pragma unroll 1
    for (int b = a + 1; b < K; ++b) {
      T c[2][3], cand[3], d2;
      pick(p, a, c[0]);
      pick(p, b, c[1]);
      solve_subset<T, 2>(c, cand, d2);
      keep_first_min(cand, d2, false, best, best_d2);
    }
  }
#pragma unroll 1
  for (int a = 0; a < K - 2; ++a) {
#pragma unroll 1
    for (int b = a + 1; b < K - 1; ++b) {
#pragma unroll 1
      for (int e = b + 1; e < K; ++e) {
        T c[3][3], cand[3], d2;
        pick(p, a, c[0]);
        pick(p, b, c[1]);
        pick(p, e, c[2]);
        solve_subset<T, 3>(c, cand, d2);
        keep_first_min(cand, d2, false, best, best_d2);
      }
    }
  }
  if constexpr (K > 3) {
    // interior test in residual form: NaN-propagating amin / amax (only
    // the comparison reads them, so zero signs do not matter)
    T qc_min = T(0), pscale = T(0);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const T qc = asum3(r::mul(r::sub(p[i][0], best[0]), best[0]),
                         r::mul(r::sub(p[i][1], best[1]), best[1]),
                         r::mul(r::sub(p[i][2], best[2]), best[2]));
      const T pp = asum3(r::mul(p[i][0], p[i][0]), r::mul(p[i][1], p[i][1]),
                         r::mul(p[i][2], p[i][2]));
      if (i == 0) {
        qc_min = qc;
        pscale = pp;
      } else {
        qc_min = (isnan(qc) || qc < qc_min) ? qc : qc_min;
        pscale = (isnan(pp) || pp > pscale) ? pp : pscale;
      }
    }
    if (qc_min < r::mul(pscale, R<T>::kNegTol)) {
      best[0] = best[1] = best[2] = T(0);
      best_d2 = T(0);
    }
  }
  const T dist = r::sqrt(best_d2);

  // ops/hull.py::hull_normal
  T nt[3];
  if (dist > T(1e-10)) {
    const T den = clamp_min(dist, T(1e-10));
#pragma unroll
    for (int d = 0; d < 3; ++d) nt[d] = r::div(best[d], den);
  } else {
    nt[0] = T(1);
    nt[1] = T(0);
    nt[2] = T(0);
  }

  // the rest of constraints.lsc_planes
  const T normal[3] = {nt[0], nt[1], r::div(nt[2], dw)};
  const bool rsfc = slack_flags != nullptr && slack_flags[no] && !is_agent;
  T* rhs = rhs_out + h * K;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const T e = asum3(r::mul(p[i][0], nt[0]), r::mul(p[i][1], nt[1]),
                      r::mul(p[i][2], nt[2]));
    T d = r::mul(T(0.5), r::add(rsum, e));
    if (use_guard) {
      const T s0 = r::mul(T(0.5), r::sub(e, rsum));
      d = r::add(d, clamp(r::mul(T(0.5), s0), T(0), guard));
    }
    if (rsfc) d = r::add(obs_pred_sizes[h * K + i], ar);
    rhs[i] = r::add(d, asum3(r::mul(op[3 * i], normal[0]),
                             r::mul(op[3 * i + 1], normal[1]),
                             r::mul(op[3 * i + 2], normal[2])));
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) normal_out[h * 3 + d] = normal[d];
}

template <typename T, int K>
void launch_k(const void* init_traj, const void* obs_pred,
              const void* agent_radius, const void* agent_downwash,
              const void* obs_radius, const void* obs_downwash,
              const void* obs_is_agent, const void* slack_flags,
              const void* obs_pred_sizes, double guard, void* normal_out,
              void* rhs_out, long long hulls, int O, int M,
              cudaStream_t stream) {
  const long long blocks = (hulls + kThreads - 1) / kThreads;
  lsc_planes_kernel<T, K><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(
      static_cast<const T*>(init_traj), static_cast<const T*>(obs_pred),
      static_cast<const T*>(agent_radius),
      static_cast<const T*>(agent_downwash),
      static_cast<const T*>(obs_radius), static_cast<const T*>(obs_downwash),
      static_cast<const bool*>(obs_is_agent),
      static_cast<const bool*>(slack_flags),
      static_cast<const T*>(obs_pred_sizes), static_cast<T>(guard),
      guard > 0.0, static_cast<T*>(normal_out), static_cast<T*>(rhs_out),
      hulls, O, M);
}

template <typename T>
int launch(const void* init_traj, const void* obs_pred,
           const void* agent_radius, const void* agent_downwash,
           const void* obs_radius, const void* obs_downwash,
           const void* obs_is_agent, const void* slack_flags,
           const void* obs_pred_sizes, double guard, void* normal_out,
           void* rhs_out, int N, int O, int M, int K, void* stream) {
  if (N < 0 || O < 0 || M < 0 || K < 1 || K > 8 ||
      (slack_flags == nullptr) != (obs_pred_sizes == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long hulls = static_cast<long long>(N) * O * M;
  if (hulls == 0) return static_cast<int>(cudaGetLastError());
  if ((hulls + kThreads - 1) / kThreads > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LSC_PLANES_ARGS                                                  \
  init_traj, obs_pred, agent_radius, agent_downwash, obs_radius,         \
      obs_downwash, obs_is_agent, slack_flags, obs_pred_sizes, guard,    \
      normal_out, rhs_out, hulls, O, M, s
  switch (K) {
    case 1: launch_k<T, 1>(LSC_PLANES_ARGS); break;
    case 2: launch_k<T, 2>(LSC_PLANES_ARGS); break;
    case 3: launch_k<T, 3>(LSC_PLANES_ARGS); break;
    case 4: launch_k<T, 4>(LSC_PLANES_ARGS); break;
    case 5: launch_k<T, 5>(LSC_PLANES_ARGS); break;
    case 6: launch_k<T, 6>(LSC_PLANES_ARGS); break;
    case 7: launch_k<T, 7>(LSC_PLANES_ARGS); break;
    default: launch_k<T, 8>(LSC_PLANES_ARGS); break;
  }
#undef LSC_PLANES_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// init_traj (N, M, K, 3); obs_pred (N, O, M, K, 3); agent_radius,
// agent_downwash (N,); obs_radius, obs_downwash (N, O); obs_is_agent
// (N, O) bool; slack_flags (N, O) bool and obs_pred_sizes (N, O, M, K),
// both or neither (null); guard, the guard band (applied when > 0) ->
// normal_out (N, O, M, 3), rhs_out (N, O, M, K).  K from 1 to 8.
int lsc_planes_f32(const void* init_traj, const void* obs_pred,
                   const void* agent_radius, const void* agent_downwash,
                   const void* obs_radius, const void* obs_downwash,
                   const void* obs_is_agent, const void* slack_flags,
                   const void* obs_pred_sizes, double guard,
                   void* normal_out, void* rhs_out, int N, int O, int M,
                   int K, void* stream) {
  return launch<float>(init_traj, obs_pred, agent_radius, agent_downwash,
                       obs_radius, obs_downwash, obs_is_agent, slack_flags,
                       obs_pred_sizes, guard, normal_out, rhs_out, N, O, M,
                       K, stream);
}

int lsc_planes_f64(const void* init_traj, const void* obs_pred,
                   const void* agent_radius, const void* agent_downwash,
                   const void* obs_radius, const void* obs_downwash,
                   const void* obs_is_agent, const void* slack_flags,
                   const void* obs_pred_sizes, double guard,
                   void* normal_out, void* rhs_out, int N, int O, int M,
                   int K, void* stream) {
  return launch<double>(init_traj, obs_pred, agent_radius, agent_downwash,
                        obs_radius, obs_downwash, obs_is_agent, slack_flags,
                        obs_pred_sizes, guard, normal_out, rhs_out, N, O, M,
                        K, stream);
}

}  // extern "C"
