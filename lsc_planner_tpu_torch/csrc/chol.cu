// Batched Cholesky factor + triangular solves for the interior-point QP.
//
// Replaces lsc_planner_tpu/ops/chol_pallas.py::_factor_solve_kernel
// (factor H = L L^T, then solve L L^T x = rhs) and ::_resolve_kernel
// (solve again with a kept factor).  Same semantics: right-looking lower
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
// the launch itself, the 2 n block barriers of the column-by-column
// factorization, and the n-long dependent chains of the substitutions.
// The design keeps every one of those steps on chip: one thread block per
// QP instance (B blocks spread over the SMs), H held in shared memory
// (n^2 words, 6 KB at n = 39 in f32), two barriers per column, and the
// substitutions run by one warp that keeps the right-hand side in
// registers (lane l owns rows l and l + 32) and broadcasts each solved
// entry with a shuffle, so they need no barrier at all.  chol_resolve
// reloads L into shared memory with the whole block (coalesced) and then
// solves with one warp.  Several instances per block, register tiling and
// CUDA-graph capture of the IPM's per-iteration launches are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (lsc_planner_tpu_torch/ops/_build.py).
// Interface: plain C, pointers to contiguous device memory, the CUDA
// stream as an opaque pointer; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;       // two rows per lane in the one-warp solve
constexpr int kThreads = 128;

// Solve (L L^T) x = rhs for one instance with warp 0.  L is row-major
// n x n in shared memory (only the lower triangle is read).
template <typename T>
__device__ void solve_warp(const T* L, int n, const T* rhs, T* x) {
  const int lane = threadIdx.x & 31;
  const int r0 = lane;
  const int r1 = lane + 32;
  T z0 = r0 < n ? rhs[r0] : T(0);
  T z1 = r1 < n ? rhs[r1] : T(0);
  // forward: L z = rhs
  for (int k = 0; k < n; ++k) {
    const T held = k < 32 ? z0 : z1;
    const T zk = __shfl_sync(0xffffffffu, held, k & 31) / L[k * n + k];
    if (r0 == k) z0 = zk;
    if (r1 == k) z1 = zk;
    if (r0 > k && r0 < n) z0 -= L[r0 * n + k] * zk;
    if (r1 > k && r1 < n) z1 -= L[r1 * n + k] * zk;
  }
  // backward: L^T x = z (column k of L^T is row k of L)
  for (int k = n - 1; k >= 0; --k) {
    const T held = k < 32 ? z0 : z1;
    const T xk = __shfl_sync(0xffffffffu, held, k & 31) / L[k * n + k];
    if (r0 == k) z0 = xk;
    if (r1 == k) z1 = xk;
    if (r0 < k) z0 -= L[k * n + r0] * xk;
    if (r1 < k) z1 -= L[k * n + r1] * xk;
  }
  if (r0 < n) x[r0] = z0;
  if (r1 < n) x[r1] = z1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
factor_solve_kernel(const T* __restrict__ H, const T* __restrict__ rhs,
                    T* __restrict__ L_out, T* __restrict__ x, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* A = reinterpret_cast<T*>(smem);   // n x n working matrix -> L
  T* col = A + n * n;                  // scaled column k
  const int nn = n * n;
  const size_t b = blockIdx.x;
  const T* Hb = H + b * nn;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) A[e] = Hb[e];
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    // no pivot floor: a non-positive pivot gives NaN/inf, which spreads
    // through this instance only
    const T inv = T(1) / sqrt(A[k * n + k]);
    for (int i = k + threadIdx.x; i < n; i += blockDim.x)
      col[i] = A[i * n + k] * inv;
    __syncthreads();
    // rank-1 update of the trailing lower triangle, column k -> L
    const int m = n - k - 1;
    for (int e = threadIdx.x; e < m * m; e += blockDim.x) {
      const int i = k + 1 + e / m;
      const int j = k + 1 + e % m;
      if (j <= i) A[i * n + j] -= col[i] * col[j];
    }
    for (int i = k + threadIdx.x; i < n; i += blockDim.x)
      A[i * n + k] = col[i];
    __syncthreads();
  }

  T* Lb = L_out + b * nn;
  for (int e = threadIdx.x; e < nn; e += blockDim.x)
    Lb[e] = (e % n) <= (e / n) ? A[e] : T(0);
  if (threadIdx.x < 32) solve_warp(A, n, rhs + b * n, x + b * n);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
resolve_kernel(const T* __restrict__ L, const T* __restrict__ rhs,
               T* __restrict__ x, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* A = reinterpret_cast<T*>(smem);
  const int nn = n * n;
  const size_t b = blockIdx.x;
  const T* Lb = L + b * nn;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) A[e] = Lb[e];
  __syncthreads();
  if (threadIdx.x < 32) solve_warp(A, n, rhs + b * n, x + b * n);
}

template <typename T>
int launch_factor_solve(const void* H, const void* rhs, void* L, void* x,
                        int B, int n, void* stream) {
  if (n < 1 || n > kMaxN || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(n * n + n) * sizeof(T);
  factor_solve_kernel<T><<<B, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(H), static_cast<const T*>(rhs),
      static_cast<T*>(L), static_cast<T*>(x), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_resolve(const void* L, const void* rhs, void* x, int B, int n,
                   void* stream) {
  if (n < 1 || n > kMaxN || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(n * n) * sizeof(T);
  resolve_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), static_cast<const T*>(rhs),
      static_cast<T*>(x), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int lsc_chol_factor_solve_f32(const void* H, const void* rhs, void* L,
                              void* x, int B, int n, void* stream) {
  return launch_factor_solve<float>(H, rhs, L, x, B, n, stream);
}

int lsc_chol_factor_solve_f64(const void* H, const void* rhs, void* L,
                              void* x, int B, int n, void* stream) {
  return launch_factor_solve<double>(H, rhs, L, x, B, n, stream);
}

int lsc_chol_resolve_f32(const void* L, const void* rhs, void* x, int B,
                         int n, void* stream) {
  return launch_resolve<float>(L, rhs, x, B, n, stream);
}

int lsc_chol_resolve_f64(const void* L, const void* rhs, void* x, int B,
                         int n, void* stream) {
  return launch_resolve<double>(L, rhs, x, B, n, stream);
}

}  // extern "C"
