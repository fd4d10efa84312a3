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
//
// Large n (64 < n <= 4096: the slack-relaxed QP's KKT system, n = nv +
// C M, 359 at 64 agents).  Where a thread-block cluster of one or two
// blocks holds the factor in its shared memory (cluster_plan: f32 up to n
// = 384, f64 up to 256), one cluster a matrix with L resident on chip
// (chol_cluster.cuh, which has its own note).  Past that, the tiled design
// (chol_tiled.cuh, its own note): one persistent launch of the factor for
// the whole batch, 64 x 64 tiles of L in device memory taken as tasks in
// one fixed order (each tile left-looking, one writer, its sums in one
// order), then a warp-specialised solve, one block a matrix; resolve runs
// that solve alone on a kept L, so it returns factor_solve's x bit for
// bit, and the factor alone is the factor launch alone, so it returns
// factor_solve's L bit for bit.  The factor takes a zeroed workspace of
// ints (chol_tiled::work_ints: a task counter, a flag a tile and a failed
// flag an entry; the launch zeroes it with cudaMemsetAsync).
//
// The first design past the clusters, one block of 256 threads a matrix
// (big_factor_solve_kernel, big_resolve_kernel: right-looking 32-wide
// panels, warp 0 factoring each diagonal tile, three block barriers a
// panel step, L in device memory, n <= 1024), stays behind
// -DLSC_CHOL_ONE_BLOCK, a measurement build: it then takes the shapes the
// tiled design takes (up to 1024).  Built with -DLSC_CHOL_MAX_G=0 (also a
// measurement build, never the package's) no cluster runs: the tiled
// design (or, with LSC_CHOL_ONE_BLOCK, the one-block kernels) takes every
// large n; with 4 or 8, clusters of up to 4 or 8 blocks take the shapes
// they hold.

// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (lsc_planner_tpu_torch/ops/_build.py).
// Interface: plain C, pointers to contiguous device memory, the CUDA
// stream as an opaque pointer; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "chol_cluster.cuh"
#include "chol_tiled.cuh"
#include "warp_chol.cuh"

namespace {

constexpr int kMaxN = 64;      // two rows per lane in the one-warp solve
constexpr int kFsWarps = 4;   // matrices a block: the kernels up to kMaxN
constexpr int kLargeMaxN = chol_tiled::kMaxN;   // the wrappers' cap
constexpr int kClusterMaxN = chol_cluster::kMaxNt * chol_cluster::kT;

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

#ifdef LSC_CHOL_ONE_BLOCK
// ---------------------------------------------------------------------
// The first design past the clusters, one block a matrix (see the note
// at the top), n <= kBigMaxN: measurement builds only (LSC_CHOL_ONE_BLOCK)
// ---------------------------------------------------------------------

constexpr int kBigMaxN = 1024;          // the block-a-matrix kernels' cap
constexpr int kPanel = 32;              // their panel width
constexpr int kBigWarps = 8;
constexpr int kBigThreads = kBigWarps * 32;
constexpr int kTile = kPanel * (kPanel + 1);   // a padded panel block
constexpr size_t kBigSmemCap = 200 * 1024;     // f64 at kBigMaxN: 156 KB

// Shared memory of the large-n kernels, in elements of T: the diagonal's
// reciprocals and the solve's vector (n each), a diagonal tile, and (the
// factor only) two padded panel blocks a warp.
__host__ __device__ __forceinline__ size_t big_smem_elems(int n,
                                                          bool panels) {
  return 2 * static_cast<size_t>(n) + kPanel * kPanel +
         (panels ? static_cast<size_t>(kBigWarps) * 2 * kTile : 0);
}

// Solves (L L^T) x = z in place: L row-major in device memory, z (n) and
// rinv (the diagonal's reciprocals) in shared memory, Dt a kPanel^2 tile.
// Every thread of the block calls it.
template <typename T>
__device__ void big_solve(const T* __restrict__ Lb, int n,
                          const T* __restrict__ rinv, T* z, T* Dt) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  LSC_STAMP_DECL(t0);
  for (int k0 = 0; k0 < n; k0 += kPanel) {          // forward
    const int kb = min(kPanel, n - k0), k1 = k0 + kb;
    if (w == 0) {
#pragma unroll
      for (int i = 0; i < kPanel; ++i)                // loads in flight
        if (i < kb && lane < kb) Dt[i * kPanel + lane] =
            Lb[static_cast<size_t>(k0 + i) * n + k0 + lane];
      __syncwarp();
      T zr = lane < kb ? z[k0 + lane] : T(0);
      const T ri = lane < kb ? rinv[k0 + lane] : T(0);
      for (int k = 0; k < kb; ++k) {
        const T zk = __shfl_sync(warp_chol::kFull, zr * ri, k);
        if (lane == k) zr = zk;
        if (lane > k && lane < kb) zr -= Dt[lane * kPanel + k] * zk;
      }
      if (lane < kb) z[k0 + lane] = zr;
    }
    __syncthreads();
    for (int i = k1 + tid; i < n; i += kBigThreads) {   // kb == kPanel
      const T* row = Lb + static_cast<size_t>(i) * n + k0;
      T acc = T(0);
#pragma unroll
      for (int t = 0; t < kPanel; ++t) acc += row[t] * z[k0 + t];
      z[i] -= acc;
    }
    __syncthreads();
  }
  LSC_STAMP(blockIdx.x == 0 && tid == 0, chol_cluster::kStFwd, t0);
  for (int k0 = ((n - 1) / kPanel) * kPanel; k0 >= 0; k0 -= kPanel) {
    const int kb = min(kPanel, n - k0);              // backward
    if (w == 0) {
#pragma unroll
      for (int i = 0; i < kPanel; ++i)                // loads in flight
        if (i < kb && lane < kb) Dt[i * kPanel + lane] =
            Lb[static_cast<size_t>(k0 + i) * n + k0 + lane];
      __syncwarp();
      T zr = lane < kb ? z[k0 + lane] : T(0);
      const T ri = lane < kb ? rinv[k0 + lane] : T(0);
      for (int k = kb - 1; k >= 0; --k) {
        const T xk = __shfl_sync(warp_chol::kFull, zr * ri, k);
        if (lane == k) zr = xk;
        if (lane < k) zr -= Dt[k * kPanel + lane] * xk;
      }
      if (lane < kb) z[k0 + lane] = zr;
    }
    __syncthreads();
    for (int i = tid; i < k0; i += kBigThreads) {       // column i
      T acc = T(0);
#pragma unroll 8
      for (int t = 0; t < kb; ++t)
        acc += Lb[static_cast<size_t>(k0 + t) * n + i] * z[k0 + t];
      z[i] -= acc;
    }
    __syncthreads();
  }
  LSC_STAMP(blockIdx.x == 0 && tid == 0, chol_cluster::kStBwd, t0);
}

// factor_solve (kSolve) and the factor alone, one block a matrix.
template <typename T, bool kSolve>
__global__ void __launch_bounds__(kBigThreads, 1)
big_factor_solve_kernel(const T* __restrict__ H, const T* __restrict__ rhs,
                        T* __restrict__ L_out, T* __restrict__ x, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int failed;
  T* rinv = reinterpret_cast<T*>(smem);
  T* z = rinv + n;
  T* Dt = z + n;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  T* Pi = Dt + kPanel * kPanel + w * 2 * kTile;       // this warp's blocks
  T* Pj = Pi + kTile;
  const size_t b = blockIdx.x;
  const size_t nn = static_cast<size_t>(n) * n;
  const T* Hb = H + b * nn;
  T* Lb = L_out + b * nn;
  LSC_STAMP_DECL(t0);
  LSC_STAMP_DECL(t_all);
  if (tid == 0) failed = 0;
  // H's lower triangle into L, zeros above: a warp a row
  for (int i = w; i < n; i += kBigWarps)
#pragma unroll 4
    for (int j = lane; j < n; j += 32)
      Lb[static_cast<size_t>(i) * n + j] =
          j <= i ? Hb[static_cast<size_t>(i) * n + j] : T(0);
  __syncthreads();
  LSC_STAMP(b == 0 && tid == 0, chol_cluster::kStLoad, t0);

  for (int k0 = 0; k0 < n; k0 += kPanel) {
    const int kb = min(kPanel, n - k0), k1 = k0 + kb;
    if (w == 0) {             // the diagonal tile, in warp 0's registers
#pragma unroll
      for (int i = 0; i < kPanel; ++i)                // loads in flight
        if (i < kb && lane < kb) Dt[i * kb + lane] =
            Lb[static_cast<size_t>(k0 + i) * n + k0 + lane];
      __syncwarp();
      warp_chol::Rows<T, kPanel> R;
      warp_chol::load_rows(R, kb, [&](int i, int j) { return Dt[i * kb + j]; });
      T r0, r1;
      const bool bad = warp_chol::factor(R, kb, -static_cast<T>(INFINITY),
                                         r0, r1, Dt);
      if (lane < kb) rinv[k0 + lane] = r0;
      for (int i = 0; i < kb; ++i)
        if (lane < kb)
          Lb[static_cast<size_t>(k0 + i) * n + k0 + lane] = Dt[i * kb + lane];
      if (bad && lane == 0) failed = 1;
    }
    __syncthreads();
    LSC_STAMP(b == 0 && tid == 0, chol_cluster::kStDiag, t0);
    if (k1 >= n) break;
    // the panel below the tile (kb == kPanel): a thread a row,
    // v = a L_tile^-T by forward substitution
    for (int i = k1 + tid; i < n; i += kBigThreads) {
      T* row = Lb + static_cast<size_t>(i) * n + k0;
      T v[kPanel];
#pragma unroll
      for (int j = 0; j < kPanel; ++j) v[j] = row[j];
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        T a = v[j];
#pragma unroll
        for (int t = 0; t < j; ++t) a -= v[t] * Dt[j * kPanel + t];
        v[j] = a * rinv[k0 + j];
      }
#pragma unroll
      for (int j = 0; j < kPanel; ++j) row[j] = v[j];
    }
    __syncthreads();
    LSC_STAMP(b == 0 && tid == 0, chol_cluster::kStPanel, t0);
    // the trailing lower triangle, tile (a, c), a >= c, warp by warp:
    // L[I + i][J + lane] -= panel row I + i . panel row J + lane
    const int tiles = (n - k1 + kPanel - 1) / kPanel;
    for (int t = w; t < tiles * (tiles + 1) / 2; t += kBigWarps) {
      int a = 0;
      while ((a + 1) * (a + 2) / 2 <= t) ++a;
      const int c = t - a * (a + 1) / 2;
      const int I = k1 + a * kPanel, J = k1 + c * kPanel;
#pragma unroll
      for (int i = 0; i < kPanel; ++i) {              // loads in flight
        Pi[i * (kPanel + 1) + lane] =
            I + i < n ? Lb[static_cast<size_t>(I + i) * n + k0 + lane] : T(0);
        Pj[i * (kPanel + 1) + lane] =
            J + i < n ? Lb[static_cast<size_t>(J + i) * n + k0 + lane] : T(0);
      }
      __syncwarp();
      T pj[kPanel];
#pragma unroll
      for (int u = 0; u < kPanel; ++u) pj[u] = Pj[lane * (kPanel + 1) + u];
      const int col = J + lane;
      // eight rows at a time: their entries of L read together, then
      // updated
      for (int i0 = 0; i0 < kPanel; i0 += 8) {
        T cur[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int row = I + i0 + r;
          cur[r] = row < n && col < n && col <= row
                       ? Lb[static_cast<size_t>(row) * n + col] : T(0);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const T* pi = Pi + (i0 + r) * (kPanel + 1);
          T acc = T(0);
#pragma unroll
          for (int u = 0; u < kPanel; ++u) acc += pi[u] * pj[u];
          const int row = I + i0 + r;
          if (row < n && col < n && col <= row)
            Lb[static_cast<size_t>(row) * n + col] = cur[r] - acc;
        }
      }
      __syncwarp();           // before the next tile overwrites Pi, Pj
    }
    __syncthreads();
    LSC_STAMP(b == 0 && tid == 0, chol_cluster::kStTrail, t0);
  }

  const T nan = quiet_nan<T>();
  if (failed) {               // the lower triangle all NaN
    for (int i = w; i < n; i += kBigWarps)
      for (int j = lane; j <= i; j += 32)
        Lb[static_cast<size_t>(i) * n + j] = nan;
    __syncthreads();
  }
  if constexpr (kSolve) {
    for (int i = tid; i < n; i += kBigThreads) z[i] = rhs[b * n + i];
    __syncthreads();
    LSC_STAMP(b == 0 && tid == 0, chol_cluster::kStWrite, t0);
    big_solve(Lb, n, rinv, z, Dt);
    for (int i = tid; i < n; i += kBigThreads)
      x[b * n + i] = failed ? nan : z[i];
  }
  LSC_STAMP(b == 0 && tid == 0, chol_cluster::kStTotal, t_all);
}

// resolve, one block a matrix: factor_solve's solve on a kept L.
template <typename T>
__global__ void __launch_bounds__(kBigThreads, 1)
big_resolve_kernel(const T* __restrict__ L, const T* __restrict__ rhs,
                   T* __restrict__ x, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* rinv = reinterpret_cast<T*>(smem);
  T* z = rinv + n;
  T* Dt = z + n;
  const size_t b = blockIdx.x;
  const T* Lb = L + b * static_cast<size_t>(n) * n;
  for (int i = threadIdx.x; i < n; i += kBigThreads) {
    rinv[i] = T(1) / Lb[static_cast<size_t>(i) * n + i];   // as factor()
    z[i] = rhs[b * n + i];
  }
  __syncthreads();
  big_solve(Lb, n, rinv, z, Dt);
  for (int i = threadIdx.x; i < n; i += kBigThreads) x[b * n + i] = z[i];
}

// Lets kernel take `bytes` of dynamic shared memory on the current device,
// once a device: no attribute call inside a captured CUDA graph after the
// first, uncaptured, launch.
template <class K>
int allow_smem(K kernel, size_t bytes, bool* done) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (done[dev]) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kBigSmemCap));
  if (err != cudaSuccess) return static_cast<int>(err);
  done[dev] = true;
  return 0;
}

template <typename T, bool kSolve>
int launch_big_factor(const T* H, const T* rhs, T* L, T* x, int B, int n,
                      cudaStream_t stream) {
  static bool done[64];
  const size_t smem = big_smem_elems(n, true) * sizeof(T);
  const int err = allow_smem(big_factor_solve_kernel<T, kSolve>, smem, done);
  if (err) return err;
  big_factor_solve_kernel<T, kSolve><<<B, kBigThreads, smem, stream>>>(
      H, rhs, L, x, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_big_resolve(const T* L, const T* rhs, T* x, int B, int n,
                       cudaStream_t stream) {
  static bool done[64];
  const size_t smem = big_smem_elems(n, false) * sizeof(T);
  const int err = allow_smem(big_resolve_kernel<T>, smem, done);
  if (err) return err;
  big_resolve_kernel<T><<<B, kBigThreads, smem, stream>>>(L, rhs, x, n);
  return static_cast<int>(cudaGetLastError());
}
#endif  // LSC_CHOL_ONE_BLOCK

// The tiled design: a grid of as many factor blocks as are resident on the
// device (queried once a device, at the first, uncaptured launch, as is the
// solve's shared-memory attribute: no query or attribute call inside a
// captured CUDA graph after that), at most one a task.
template <typename T>
int tiled_prepare(int* grid) {
  static int resident[64];
  static bool solve_smem[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!resident[dev]) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chol_tiled::tiled_factor_kernel<T>, chol_tiled::kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    resident[dev] = per_sm * sms;
  }
  if (!solve_smem[dev]) {
    const size_t most = chol_tiled::solve_smem_bytes<T>(chol_tiled::kMaxN);
    if (most > 48 * 1024) {
      err = cudaFuncSetAttribute(chol_tiled::tiled_solve_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(most));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    solve_smem[dev] = true;
  }
  *grid = resident[dev];
  return 0;
}

template <typename T>
int launch_tiled_solve(const T* L, const T* rhs, T* x, int B, int n,
                       cudaStream_t stream) {
  int grid = 0;
  const int err = tiled_prepare<T>(&grid);
  if (err) return err;
  chol_tiled::tiled_solve_kernel<T>
      <<<B, chol_tiled::Solve<T>::kThreads,
         chol_tiled::solve_smem_bytes<T>(n), stream>>>(L, rhs, x, n);
  return static_cast<int>(cudaGetLastError());
}

// the factor (work: chol_tiled::work_ints(n, B) ints, zeroed here), then
// with kSolve the solve of the same L
template <typename T, bool kSolve>
int launch_tiled_factor(const T* H, const T* rhs, T* L, T* x, int* work,
                        int B, int n, cudaStream_t stream) {
  if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  int err = tiled_prepare<T>(&grid);
  if (err) return err;
  const cudaError_t e = cudaMemsetAsync(
      work, 0, sizeof(int) * chol_tiled::work_ints(n, B), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tasks = chol_tiled::task_count(n, B);
  if (tasks < grid) grid = static_cast<int>(tasks);
  chol_tiled::tiled_factor_kernel<T>
      <<<grid, chol_tiled::kThreads, 0, stream>>>(H, L, work, n, B);
  err = static_cast<int>(cudaGetLastError());
  if (err || !kSolve) return err;
  return launch_tiled_solve<T>(L, rhs, x, B, n, stream);
}

// The cluster design's plan for (n, element bytes): G blocks a matrix (0
// where no cluster of at most kMaxG holds the factor, or n <= kMaxN: the
// one-block kernels run) and the shared-memory bytes a block of the
// factor and of the resolve, the largest over the cluster's blocks.
// ops/chol.py::large_plan mirrors it.
struct ClusterPlan {
  int G;
  size_t smem_factor, smem_resolve;
};

ClusterPlan cluster_plan(int n, int elem) {
  if (n <= kMaxN || n > kClusterMaxN) return {0, 0, 0};
  for (int G = 1; G <= chol_cluster::kMaxG; G *= 2) {
    size_t f = 0, r = 0;
    for (int rank = 0; rank < G; ++rank) {
      const chol_cluster::Geo g(n, G, rank);
      f = std::max(f, g.smem_bytes(rank, true, elem));
      r = std::max(r, g.smem_bytes(rank, false, elem));
    }
    if (f <= chol_cluster::kSmemCap) return {G, f, r};
  }
  return {0, 0, 0};
}

cudaLaunchConfig_t cluster_config(int blocks, int G, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(chol_cluster::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = G;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Once a device, at the first (uncaptured) launch of kernel: allows it the
// most dynamic shared memory a block can have, and checks that a cluster
// of each size (1, 2, .., kMaxG) of such blocks can be resident at all; no
// attribute call or query inside a captured CUDA graph after that.
template <class K>
int prepare_cluster(K kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (done[dev]) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(chol_cluster::kSmemCap));
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int G = 1; G <= chol_cluster::kMaxG; G *= 2) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(G, G, chol_cluster::kSmemCap, nullptr, &attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  }
  done[dev] = true;
  return 0;
}

template <typename T, bool kSolve>
int launch_cluster_factor(const T* H, const T* rhs, T* L, T* x, int B,
                          int n, const ClusterPlan& p, cudaStream_t stream) {
  static bool done[64];
  auto kernel = chol_cluster::cluster_factor_kernel<T, kSolve>;
  const int err = prepare_cluster(kernel, done);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(B * p.G, p.G, p.smem_factor, stream, &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, H, rhs, L, x, n,
                                           p.G);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T>
int launch_cluster_resolve(const T* L, const T* rhs, T* x, int B, int n,
                           const ClusterPlan& p, cudaStream_t stream) {
  static bool done[64];
  auto kernel = chol_cluster::cluster_resolve_kernel<T>;
  const int err = prepare_cluster(kernel, done);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(B * p.G, p.G, p.smem_resolve, stream, &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, L, rhs, x, n, p.G);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
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
                        void* work, int B, int n, void* stream) {
  if (n < 1 || n > kLargeMaxN || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const T* h = static_cast<const T*>(H);
  const T* r = static_cast<const T*>(rhs);
  T* l = static_cast<T*>(L);
  T* xx = static_cast<T*>(x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > kMaxN) {
    const ClusterPlan p = cluster_plan(n, sizeof(T));
    if (p.G)
      return launch_cluster_factor<T, kSolve>(h, r, l, xx, B, n, p, st);
#ifdef LSC_CHOL_ONE_BLOCK
    (void)work;
    if (n > kBigMaxN) return static_cast<int>(cudaErrorInvalidValue);
    return launch_big_factor<T, kSolve>(h, r, l, xx, B, n, st);
#else
    return launch_tiled_factor<T, kSolve>(h, r, l, xx,
                                          static_cast<int*>(work), B, n, st);
#endif
  }
  // NC = 40 holds the QP's n = 39; NC = 64 every other n up to kMaxN
  if (n <= 40)
    return launch_factor_solve_nc<T, 40, kSolve>(h, r, l, xx, B, n, st);
  return launch_factor_solve_nc<T, 64, kSolve>(h, r, l, xx, B, n, st);
}

template <typename T>
int launch_resolve(const void* L, const void* rhs, void* x, int B, int n,
                   void* stream) {
  if (n < 1 || n > kLargeMaxN || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  if (n > kMaxN) {
    const T* l = static_cast<const T*>(L);
    const T* r = static_cast<const T*>(rhs);
    T* xx = static_cast<T*>(x);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const ClusterPlan p = cluster_plan(n, sizeof(T));
    if (p.G) return launch_cluster_resolve<T>(l, r, xx, B, n, p, st);
#ifdef LSC_CHOL_ONE_BLOCK
    if (n > kBigMaxN) return static_cast<int>(cudaErrorInvalidValue);
    return launch_big_resolve<T>(l, r, xx, B, n, st);
#else
    return launch_tiled_solve<T>(l, r, xx, B, n, st);
#endif
  }
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

// work: chol_tiled::work_ints(n, B) ints of device memory for the tiled
// design (lsc_chol_tiled_work), null where another design runs
int lsc_chol_factor_solve_f32(const void* H, const void* rhs, void* L,
                              void* x, void* work, int B, int n,
                              void* stream) {
  return launch_factor_solve<float, true>(H, rhs, L, x, work, B, n, stream);
}

int lsc_chol_factor_solve_f64(const void* H, const void* rhs, void* L,
                              void* x, void* work, int B, int n,
                              void* stream) {
  return launch_factor_solve<double, true>(H, rhs, L, x, work, B, n, stream);
}

int lsc_chol_resolve_f32(const void* L, const void* rhs, void* x, int B,
                         int n, void* stream) {
  return launch_resolve<float>(L, rhs, x, B, n, stream);
}

int lsc_chol_factor_f32(const void* H, void* L, void* work, int B, int n,
                        void* stream) {
  return launch_factor_solve<float, false>(H, nullptr, L, nullptr, work, B,
                                           n, stream);
}

int lsc_chol_factor_f64(const void* H, void* L, void* work, int B, int n,
                        void* stream) {
  return launch_factor_solve<double, false>(H, nullptr, L, nullptr, work,
                                            B, n, stream);
}

int lsc_chol_resolve_f64(const void* L, const void* rhs, void* x, int B,
                         int n, void* stream) {
  return launch_resolve<double>(L, rhs, x, B, n, stream);
}

// ints of the tiled design's workspace at (n, B)
long long lsc_chol_tiled_work(int n, int B) {
  return static_cast<long long>(chol_tiled::work_ints(n, B));
}

// out: (entry, tile row, tile column) of the tiled factor's task t on B
// matrices of size n, (b, -1, -1) for entry b's last task; returns the
// number of tasks
long long lsc_chol_tiled_task(int n, int B, long long t, int* out) {
  const chol_tiled::Task tk = chol_tiled::task_of(t, n, B);
  out[0] = tk.b;
  out[1] = tk.i;
  out[2] = tk.j;
  return chol_tiled::task_count(n, B);
}

// out: G, the factor's and the resolve's shared-memory bytes a block
int lsc_chol_cluster_plan(int n, int elem, long long* out) {
  const ClusterPlan p = cluster_plan(n, elem);
  out[0] = p.G;
  out[1] = static_cast<long long>(p.smem_factor);
  out[2] = static_cast<long long>(p.smem_resolve);
  return 0;
}

// Copies the clock stamps (chol_cluster::kStamps counters of cycles) to
// the host array out and, with reset, zeroes them; -1 in a build without
// LSC_CHOL_STAMPS.
int lsc_chol_stamps(void* out, int reset) {
#ifdef LSC_CHOL_STAMPS
  cudaError_t err = cudaMemcpyFromSymbol(
      out, chol_cluster::lsc_chol_stamps,
      sizeof(unsigned long long) * chol_cluster::kStamps);
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[chol_cluster::kStamps] = {};
    err = cudaMemcpyToSymbol(chol_cluster::lsc_chol_stamps, zero,
                             sizeof zero);
  }
  return static_cast<int>(err);
#else
  (void)out;
  (void)reset;
  return -1;
#endif
}

// The tiled design's clock stamps (chol_tiled::kTsStamps counters), as
// lsc_chol_stamps.
int lsc_chol_tiled_stamps(void* out, int reset) {
#ifdef LSC_CHOL_STAMPS
  cudaError_t err = cudaMemcpyFromSymbol(
      out, chol_tiled::lsc_tiled_stamps,
      sizeof(unsigned long long) * chol_tiled::kTsStamps);
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[chol_tiled::kTsStamps] = {};
    err = cudaMemcpyToSymbol(chol_tiled::lsc_tiled_stamps, zero,
                             sizeof zero);
  }
  return static_cast<int>(err);
#else
  (void)out;
  (void)reset;
  return -1;
#endif
}

}  // extern "C"
