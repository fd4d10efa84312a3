// Batched Cholesky factor + triangular solves for the interior-point QP.
//
// Replaces lsc_planner_tpu/ops/chol_pallas.py::_factor_solve_kernel
// (factor H = L L^T, then solve L L^T x = rhs), ::_resolve_kernel
// (solve again with a kept factor) and ::_chol_kernel (the factor alone,
// cholesky_batched: a non-SPD entry's lower triangle is all NaN, so the
// kernel and its plain version, cholesky_ex with a NaN fill, agree on
// where the NaNs are).  Same semantics: right-looking lower
// Cholesky with NO pivot floor, forward then backward substitution, and a
// non-SPD instance turns into NaN in its own batch entry only (the IPM's
// degeneracy guard absorbs it).  The factor leaves the kernel as a plain
// row-major (B, n, n) lower triangle with zeros above the diagonal; the
// TPU kernel's batch-in-lanes (n, n, 128) layout is not carried over.
//
// What bounds it on an H100: latency, not FLOPs or bytes.  One instance
// at the QP's n = 39 is ~n^3/3 + 2 n^2 ~ 2.3e4 FLOPs and 6 KB of f32
// input, so a whole B = 64 launch is ~1.5e6 FLOPs and ~0.4 MB -- well
// under a microsecond of either resource.  What the time is made of is
// the launch itself, the column-by-column dependence of the factor and
// the n-long dependent chains of the substitutions.
//
// factor_solve and the factor alone (cholesky_batched): one kernel, one
// warp a matrix, four matrices a block (B = 64 is 16 blocks; B not a
// multiple of four masks the last warps).  The warp copies H into its
// shared-memory tile (coalesced, eight loads a lane in flight), takes its
// rows into registers (lane l owns rows l and l + 32, warp_chol.cuh),
// factors them with the scaled column broadcast by shuffle -- no barrier
// and no integer division at all -- and keeps each pivot's reciprocal.
// Each column goes back to the tile once it is final; the warp writes the
// tile out coalesced (zeros above the diagonal).  factor_solve then runs
// both substitutions from the tile with the right-hand side in registers,
// multiplying by the reciprocals; the factor alone stops after the write
// (a template flag, kSolve), so cholesky_batched(H) is factor_solve's L
// bit for bit: the same code up to that point.  The kernel is templated
// on a register capacity NC >= n: 40 for the QP's n = 39 and 64 for the
// rest, f32 and f64 alike; f64 at n = 39 holds 72 doubles of rows a lane.
// A non-SPD entry (a pivot <= 0 or NaN) comes back with its lower
// triangle (and factor_solve's x) all NaN, zeros above the diagonal, as
// its plain version (cholesky_ex + NaN fill) gives; the other warps of
// its block never see it.
//
// resolve: factor_solve's launch shape and its solve.  One warp a
// matrix, four a block (B not a multiple of four masks its last warps).
// The warp copies L into its own shared tile (coalesced), each lane takes
// the reciprocals of its rows' diagonal entries with warp_chol::diag_rinv
// (n divisions spread over the lanes, off the substitution chain; factor()
// keeps its reciprocals with the same code) and runs warp_chol::solve,
// factor_solve's own substitutions.  So for the same L and rhs, resolve's
// x equals factor_solve's x bit for bit.  A factor with a NaN lower
// triangle (factor_solve on a non-SPD entry) gives an all-NaN x in that
// entry; its block-mates never see it.

// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (lsc_planner_tpu_torch/ops/_build.py).
// Interface: plain C, pointers to contiguous device memory, the CUDA
// stream as an opaque pointer; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include "warp_chol.cuh"

namespace {

constexpr int kMaxN = 64;      // two rows per lane in the one-warp solve
constexpr int kFsWarps = 4;   // matrices a block: every kernel here

template <typename T> __device__ T quiet_nan();
template <> __device__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <> __device__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// factor_solve (kSolve) and the factor alone: one warp a matrix (see the
// note at the top); NC >= n.  Without kSolve, rhs and x are not read.
template <typename T, int NC, bool kSolve>
__global__ void __launch_bounds__(kFsWarps * 32)
factor_solve_kernel(const T* __restrict__ H, const T* __restrict__ rhs,
                    T* __restrict__ L_out, T* __restrict__ x, int n, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nn = n * n;
  const size_t b = static_cast<size_t>(blockIdx.x) * kFsWarps + w;
  if (b >= static_cast<size_t>(B)) return;
  T* tile = reinterpret_cast<T*>(smem) + w * nn;
  const T* Hb = H + b * nn;
#pragma unroll 8
  for (int e = lane; e < nn; e += 32) tile[e] = Hb[e];    // loads in flight
  __syncwarp();
  warp_chol::Rows<T, NC> R;
  warp_chol::load_rows(R, n, [&](int i, int j) { return tile[i * n + j]; });
  T rinv0, rinv1;
  const bool failed = warp_chol::factor(R, n, -static_cast<T>(INFINITY),
                                        rinv0, rinv1, tile);
  const T nan = quiet_nan<T>();
  if (failed)                       // the lower triangle all NaN
    for (int r = lane; r < n; r += 32)
      for (int j = 0; j <= r; ++j) tile[r * n + j] = nan;
  __syncwarp();
  T* Lb = L_out + b * nn;
  for (int e = lane; e < nn; e += 32) Lb[e] = tile[e];
  if constexpr (kSolve) {
    const int r0 = lane, r1 = lane + 32;
    T z0 = r0 < n ? rhs[b * n + r0] : T(0);
    T z1 = r1 < n ? rhs[b * n + r1] : T(0);
    warp_chol::solve(tile, n, rinv0, rinv1, z0, z1);
    if (failed) z0 = z1 = nan;
    if (r0 < n) x[b * n + r0] = z0;
    if (r1 < n) x[b * n + r1] = z1;
  }
}

// resolve: one warp a matrix, factor_solve's solve (see the note at the
// top).
template <typename T>
__global__ void __launch_bounds__(kFsWarps * 32)
resolve_kernel(const T* __restrict__ L, const T* __restrict__ rhs,
               T* __restrict__ x, int n, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nn = n * n;
  const size_t b = static_cast<size_t>(blockIdx.x) * kFsWarps + w;
  if (b >= static_cast<size_t>(B)) return;
  T* tile = reinterpret_cast<T*>(smem) + w * nn;
  const T* Lb = L + b * nn;
#pragma unroll 8
  for (int e = lane; e < nn; e += 32) tile[e] = Lb[e];    // loads in flight
  __syncwarp();
  const int r0 = lane, r1 = lane + 32;
  T rinv0, rinv1;
  warp_chol::diag_rinv(tile, n, rinv0, rinv1);             // as factor()
  T z0 = r0 < n ? rhs[b * n + r0] : T(0);
  T z1 = r1 < n ? rhs[b * n + r1] : T(0);
  warp_chol::solve(tile, n, rinv0, rinv1, z0, z1);
  if (r0 < n) x[b * n + r0] = z0;
  if (r1 < n) x[b * n + r1] = z1;
}

template <typename T, int NC, bool kSolve>
int launch_factor_solve_nc(const T* H, const T* rhs, T* L, T* x, int B, int n,
                           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kFsWarps) * n * n * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        factor_solve_kernel<T, NC, kSolve>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + kFsWarps - 1) / kFsWarps;
  factor_solve_kernel<T, NC, kSolve><<<blocks, kFsWarps * 32, smem, stream>>>(
      H, rhs, L, x, n, B);
  return static_cast<int>(cudaGetLastError());
}

// factor_solve with kSolve, the factor alone (cholesky_batched) without:
// rhs and x are then null and never read.
template <typename T, bool kSolve>
int launch_factor_solve(const void* H, const void* rhs, void* L, void* x,
                        int B, int n, void* stream) {
  if (n < 1 || n > kMaxN || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const T* h = static_cast<const T*>(H);
  const T* r = static_cast<const T*>(rhs);
  T* l = static_cast<T*>(L);
  T* xx = static_cast<T*>(x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // NC = 40 holds the QP's n = 39; NC = 64 every other n up to kMaxN
  if (n <= 40)
    return launch_factor_solve_nc<T, 40, kSolve>(h, r, l, xx, B, n, st);
  return launch_factor_solve_nc<T, 64, kSolve>(h, r, l, xx, B, n, st);
}

template <typename T>
int launch_resolve(const void* L, const void* rhs, void* x, int B, int n,
                   void* stream) {
  if (n < 1 || n > kMaxN || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(kFsWarps) * n * n * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resolve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + kFsWarps - 1) / kFsWarps;
  resolve_kernel<T><<<blocks, kFsWarps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), static_cast<const T*>(rhs),
      static_cast<T*>(x), n, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int lsc_chol_factor_solve_f32(const void* H, const void* rhs, void* L,
                              void* x, int B, int n, void* stream) {
  return launch_factor_solve<float, true>(H, rhs, L, x, B, n, stream);
}

int lsc_chol_factor_solve_f64(const void* H, const void* rhs, void* L,
                              void* x, int B, int n, void* stream) {
  return launch_factor_solve<double, true>(H, rhs, L, x, B, n, stream);
}

int lsc_chol_resolve_f32(const void* L, const void* rhs, void* x, int B,
                         int n, void* stream) {
  return launch_resolve<float>(L, rhs, x, B, n, stream);
}

int lsc_chol_factor_f32(const void* H, void* L, int B, int n,
                        void* stream) {
  return launch_factor_solve<float, false>(H, nullptr, L, nullptr, B, n,
                                          stream);
}

int lsc_chol_factor_f64(const void* H, void* L, int B, int n,
                        void* stream) {
  return launch_factor_solve<double, false>(H, nullptr, L, nullptr, B, n,
                                           stream);
}

int lsc_chol_resolve_f64(const void* L, const void* rhs, void* x, int B,
                         int n, void* stream) {
  return launch_resolve<double>(L, rhs, x, B, n, stream);
}

}  // extern "C"
