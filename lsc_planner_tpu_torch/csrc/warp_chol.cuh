// One warp factors one small SPD matrix, rows in registers.
//
// Shared by csrc/chol.cu (factor_solve, no pivot floor) and csrc/ipm.cu
// (the fused IPM's KKT factor, pivots floored at 1e-6).  Lane l owns rows
// l and l + 32 of an n x n matrix (n <= NC <= 64); each column is scaled
// in the registers that hold it and broadcast to the other lanes with
// shuffles, so the factor needs no barrier.  Each column goes to a
// shared-memory tile once it is final; the substitutions read the factor
// from there and multiply by the kept reciprocals of the diagonal instead
// of dividing.
//
// NC is a compile-time capacity, so every register index below is a
// constant after unrolling; the column loop stops at the runtime n.
#pragma once

#include <cuda_runtime.h>

namespace warp_chol {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float rsqrt_of(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_of(double x) { return rsqrt(x); }

template <typename T, int NC>
struct Rows {
  static constexpr int NA = NC < 32 ? NC : 32;   // row lane: entries 0..lane
  static constexpr int NB = NC > 32 ? NC : 1;    // row lane + 32
  T a[NA];
  T b[NB];
};

// Fills the owned rows' lower triangles with get(i, j) (j <= i < n),
// zeros elsewhere.
template <typename T, int NC, class Get>
__device__ __forceinline__ void load_rows(Rows<T, NC>& R, int n, Get get) {
  const int r0 = threadIdx.x & 31, r1 = r0 + 32;
#pragma unroll
  for (int j = 0; j < Rows<T, NC>::NA; ++j)
    R.a[j] = (r0 < n && j <= r0) ? get(r0, j) : T(0);
  if (NC > 32) {
#pragma unroll
    for (int j = 0; j < Rows<T, NC>::NB; ++j)
      R.b[j] = (r1 < n && j <= r1) ? get(r1, j) : T(0);
  }
}

// rinv0 / rinv1: the reciprocals of the diagonal entries of rows lane and
// lane + 32 of the row-major n x n factor L (zero past n).  factor() and
// chol.cu's resolve both take them here, so a resolve of factor()'s L
// gives factor_solve's x bit for bit.
template <typename T>
__device__ __forceinline__ void diag_rinv(const T* L, int n, T& rinv0,
                                          T& rinv1) {
  const int r0 = threadIdx.x & 31, r1 = r0 + 32;
  rinv0 = r0 < n ? T(1) / L[r0 * n + r0] : T(0);
  rinv1 = r1 < n ? T(1) / L[r1 * n + r1] : T(0);
}

// Right-looking lower Cholesky of the rows in R.  Each pivot is raised to
// `floor` when below it (NaN stays NaN; pass -INFINITY for no floor), and
// column k is the pivot's column times rsqrt(raised pivot) (the hardware
// reciprocal square root, as the plain versions' torch.rsqrt).  Column k
// goes to the row-major n x n tile L (shared memory; the caller's copy of
// the matrix may live there, every lane has read its rows first) as soon
// as it is final, zeros above the diagonal, so L holds the factor on
// return; rinv0 / rinv1 are the reciprocals of the owned rows' diagonal
// entries (zero past n).  Returns whether a pivot was not positive, the
// same in every lane (each lane reads the pivot from one shuffle).
//
// A column's updates carry no test: rows at and past n are zero and stay
// zero, and an entry above the diagonal only ever feeds entries above the
// diagonal (it is never stored), so row j >= n and j > row are updated
// like any other.  Without a branch between them the column's shuffles
// issue back to back; with one each waited for the last (PERF.md).
template <typename T, int NC>
__device__ __forceinline__ bool factor(Rows<T, NC>& R, int n, T floor,
                                       T& rinv0, T& rinv1, T* L) {
  constexpr int NA = Rows<T, NC>::NA, NB = Rows<T, NC>::NB;
  const int r0 = threadIdx.x & 31, r1 = r0 + 32;
  bool failed = false;
  __syncwarp();
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (k >= n) break;
    const int ka = k < NA ? k : NA - 1;
    const int kb = k < NB ? k : NB - 1;
    const T piv = __shfl_sync(kFull, k < 32 ? R.a[ka] : R.b[kb], k & 31);
    failed = failed || !(piv > T(0));
    const T inv = rsqrt_of(piv < floor ? floor : piv);
    if (k < NA) R.a[ka] *= inv;
    if (NC > 32) R.b[kb] *= inv;
    if (r0 < n) L[r0 * n + k] = (k < NA && r0 >= k) ? R.a[ka] : T(0);
    if (NC > 32 && r1 < n) L[r1 * n + k] = r1 >= k ? R.b[kb] : T(0);
#pragma unroll
    for (int j = k + 1; j < NC; ++j) {
      // L[j][k], from the lane that owns row j
      const T cj = __shfl_sync(kFull, j < 32 ? R.a[ka] : R.b[kb], j & 31);
      if (j < NA) R.a[j] -= R.a[ka] * cj;
      if (NC > 32) R.b[j < NB ? j : NB - 1] -= R.b[kb] * cj;
    }
  }
  // 1 / L[k][k], the same bits as dividing at column k, off its chain
  __syncwarp();
  diag_rinv(L, n, rinv0, rinv1);
  return failed;
}

// Solves (L L^T) x = z in place: z0 / z1 hold rows lane and lane + 32 of
// the right-hand side on entry and of x on return; L is row-major in
// shared memory; rinv0 / rinv1 as factor() returned them.
template <typename T>
__device__ __forceinline__ void solve(const T* L, int n, T rinv0, T rinv1,
                                      T& z0, T& z1) {
  const int r0 = threadIdx.x & 31, r1 = r0 + 32;
  for (int k = 0; k < n; ++k) {
    const T zk = __shfl_sync(kFull, k < 32 ? z0 * rinv0 : z1 * rinv1, k & 31);
    if (r0 == k) z0 = zk;
    if (r1 == k) z1 = zk;
    if (r0 > k && r0 < n) z0 -= L[r0 * n + k] * zk;
    if (r1 > k && r1 < n) z1 -= L[r1 * n + k] * zk;
  }
  for (int k = n - 1; k >= 0; --k) {
    const T xk = __shfl_sync(kFull, k < 32 ? z0 * rinv0 : z1 * rinv1, k & 31);
    if (r0 == k) z0 = xk;
    if (r1 == k) z1 = xk;
    if (r0 < k) z0 -= L[k * n + r0] * xk;
    if (r1 < k) z1 -= L[k * n + r1] * xk;
  }
}

}  // namespace warp_chol
