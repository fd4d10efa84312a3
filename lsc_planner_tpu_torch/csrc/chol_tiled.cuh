// Large-n batched Cholesky on Hopper past the clusters: a tiled factor
// that spreads the whole batch over the card, and a warp-specialised
// solve.
//
// Replaces, for the shapes no cluster of csrc/chol.cu::cluster_plan
// holds (f32 n > 384, f64 n > 256) up to kMaxN, lsc_planner_tpu/ops/
// chol_pallas.py::_factor_solve_kernel, ::_resolve_kernel and
// ::_chol_kernel.  Same semantics: lower Cholesky with no pivot floor,
// forward then backward substitution, a non-SPD entry NaN in its own batch
// entry only (its lower triangle and its x), the factor returned row-major
// (B, n, n) with zeros above the diagonal.
//
// What bounds it on an H100: at B = 64, n = 1024 in f32 the factor's
// 2.3e10 operations take 0.34 ms at the f32 peak and its bytes (H in, L
// out) 0.12 ms, so the factor is bound by FMAs -- if the work reaches
// every SM and the operands reach the FMA units.  The substitutions move
// L once each way and are bound by bytes and by their dependent chain of
// n / 32 diagonal solves each way.
//
// The factor (tiled_factor_kernel): L is cut into kT x kT tiles.  A tile
// (i, j) of the lower triangle is one task; its owner accumulates
// H_ij - sum_k L_ik L_jk^T in increasing k (left-looking: each tile has
// one writer and one order of its sums), then factors it (i = j, POTRF)
// or solves it against L_jj (i > j, TRSM), writes it to L and publishes a
// flag.  One persistent launch for the whole batch: about as many blocks
// as are resident, each taking tasks from a global counter in one fixed
// order -- tile by tile down the tile columns (each column's next
// diagonal tile looked ahead, task_of), each tile for the batch entries
// b = 0 .. B - 1, so the tasks of all B matrices interleave and the card
// stays full at B = 64 as at B = 1.  A task waits (ld.acquire) only on
// the flags of tasks before it in that order, and a block takes a task
// only while it runs, so the grid cannot deadlock whatever is resident.
// - The update streams the two k-tiles through shared memory in slabs of
//   kKS columns, double-buffered: each thread loads its share of the next
//   slab into registers (ld.cg: L2, never a stale L1 line of a tile being
//   written elsewhere) while it computes on this one.  A thread owns 4 x 4
//   outputs (rows ty + 16 a, columns tx + 16 b), read as 16-byte shared
//   loads along k (a slab row padded to an odd number of 16-byte chunks,
//   so a quarter-warp's loads hit distinct banks): 8 FMAs a shared load in
//   f32, 4 in f64.  Each k-tile's 64 products go to partial sums of their
//   own, subtracted when the k-tile ends: a chain of 64 then of j, where
//   one chain of 64 j lost up to 4x the accuracy of cholesky_ex at n =
//   1024 in f32.  IEEE FMAs in the tensor's type; no TF32.
// - POTRF runs on the whole block from shared memory in 16-column steps
//   (potrf_blocked): a warp factors the diagonal 16 x 16 block with
//   shuffles (IEEE sqrt and division), all warps solve the rows below it
//   and update the trailing triangle; ten barriers, where a column at a
//   time took 64 and held every tile of the next column waiting (~51K
//   cycles a POTRF at n = 1024, scripts/kernel_bits_torch.py split).
//   The order looks the next diagonal tile ahead (task_of).  TRSM (x_c
//   times the kept reciprocal of L_jj's diagonal, then the later columns)
//   runs, by type (Design), a column a step on the whole block with one
//   barrier a step (f32), or by rows, 8 a warp through shared memory,
//   each warp's 64 column steps with shuffles and no barrier (f64: the
//   tile's rows are independent).
// - A pivot <= 0 or NaN sets the entry's flag in device memory; the last
//   task of each entry waits for all of its tiles and, when the flag is
//   set, turns its lower triangle into NaN.  Tile (i, j), i > j, also
//   writes the zeros of tile (j, i); the diagonal tile its upper part.
//
// The solve (tiled_solve_kernel, both substitutions; factor_solve runs it
// after the factor, resolve alone): one block a matrix, Solve<T>::kWarps
// warps, specialised.  Warp 0 runs the chain of 32-row diagonal solves (the
// diagonal tile in shared memory, padded; the next one loaded while it
// waits) and publishes each solved block of z through a flag in shared
// memory.  The other warps stream the row slabs of L: each takes the
// slab's 32 x 32 tiles c = w - 1, w - 1 + kStreamers, .., issues the
// tile's loads (coalesced, a lane a column) before it waits for z_c, and
// keeps a column's partial sums a row (forward; reduced over the lanes at
// the end of the slab) or a lane's own row of x (backward).  Slab r + 1's
// tiles before r need only z up to r - 1, so the streamers run one slab
// ahead of the chain: only the tile next to the diagonal waits on the
// block just solved.  L is read once each way.  Every partial sum has one
// order fixed by the code, so resolve (this kernel on a kept L) returns
// factor_solve's x bit for bit, and two launches the same bits.
//
// Built with -DLSC_CHOL_STAMPS, the kernels add clock64() intervals of the
// first matrix's tasks (factor) and the first block (solve) into
// lsc_tiled_stamps (scripts/kernel_bits_torch.py split); off in the normal
// build.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace chol_tiled {

constexpr int kT = 64;                  // tile edge
constexpr int kKS = 16;                 // the update's k-slab
constexpr int kThreads = 256;           // 16 x 16, 4 x 4 outputs each
constexpr int kMaxN = 4096;             // the design's cap
constexpr int kSB = 32;                 // the solve's row block
constexpr unsigned kFull = 0xffffffffu;

// the clock stamps: cycles (kTsTasks and kTsKTiles counts).  Factor, the
// first matrix's tasks, thread 0: flag waits in the update, the update
// (waits excluded), POTRF, TRSM (L_jj's load included), writing and
// publishing the tile, the last task; the tasks and k-tiles; and (last)
// TRSM's wait for L_jj's flag.  Solve, block 0: the
// chain's diagonal solves and its waits for partials (warp 0), the
// streamers' loads and FMAs and their waits for z (summed over them), the
// total.
enum Stamp { kTsWait, kTsUpdate, kTsPotrf, kTsTrsm, kTsWrite, kTsFinal,
             kTsTasks, kTsKTiles, kTsChain, kTsChainWait, kTsStream,
             kTsStreamWait, kTsSolve, kTsTrsmWait, kTsStamps };

#ifdef LSC_CHOL_STAMPS
__device__ unsigned long long lsc_tiled_stamps[kTsStamps];
#define LSC_TSTAMP_DECL(t) long long t = clock64()
#define LSC_TSTAMP(on, slot, t)                                           \
  do {                                                                    \
    if (on) {                                                             \
      const long long now_ = clock64();                                   \
      atomicAdd(&chol_tiled::lsc_tiled_stamps[slot],                      \
                static_cast<unsigned long long>(now_ - (t)));             \
      (t) = now_;                                                         \
    }                                                                     \
  } while (0)
#define LSC_TCOUNT(on, slot)                                              \
  do {                                                                    \
    if (on) atomicAdd(&chol_tiled::lsc_tiled_stamps[slot], 1ull);         \
  } while (0)
#else
#define LSC_TSTAMP_DECL(t) ((void)0)
#define LSC_TSTAMP(on, slot, t) ((void)0)
#define LSC_TCOUNT(on, slot) ((void)0)
#endif

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<double> { using type = double2; };

template <typename T> __device__ __forceinline__ T nan_of();
template <> __device__ __forceinline__ float nan_of<float>() {
  return __int_as_float(0x7fc00000);
}
template <> __device__ __forceinline__ double nan_of<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// ---------------------------------------------------------------------
// flags: device scope between the factor's blocks, block scope between
// the solve's warps
// ---------------------------------------------------------------------
__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];\n" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release_gpu(int* p, int v) {
  asm volatile("st.release.gpu.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int ld_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.u32 %0, [%1];\n" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cta(int* p, int v) {
  asm volatile("st.release.cta.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void red_release_cta(int* p, int v) {
  asm volatile("red.release.cta.add.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Every lane of the calling warp waits until *p >= want (a flag another
// block sets; all lanes read it, so each lane's later loads are ordered
// after its own acquire).
__device__ __forceinline__ void wait_gpu(const int* p, int want) {
  while (ld_acquire_gpu(p) < want) __nanosleep(64);
}

__device__ __forceinline__ void wait_cta(const int* p, int want) {
  while (ld_acquire_cta(p) < want) {
  }
}

// ---------------------------------------------------------------------
// the task order (host and device: lsc_chol_tiled_task reads it back for
// the tests; ops/chol.py::tiled_tasks mirrors it)
// ---------------------------------------------------------------------
__host__ __device__ __forceinline__ int tile_count(int n) {
  const int nt = (n + kT - 1) / kT;
  return nt * (nt + 1) / 2;
}

// tile (i, j), j <= i, numbered column by column: (0, 0), (1, 0), ..
__host__ __device__ __forceinline__ int tile_index(int i, int j, int nt) {
  return j * nt - j * (j - 1) / 2 + (i - j);
}

struct Task {
  int b, i, j;      // i = j = -1: entry b's last task (the NaN fill)
};

// Task t of a launch on B matrices: tile t / B of one matrix's order,
// entry t % B; then one last task for each entry.  A matrix's order is
// (0, 0), then tile column by tile column with the next diagonal tile
// looked ahead: column j's first tile (j + 1, j), then (j + 1, j + 1),
// then (j + 2, j) .. (nt - 1, j).  The diagonal tile that the next
// column's tiles wait for so starts while this column's are taken.
__host__ __device__ __forceinline__ Task task_of(long long t, int n, int B) {
  const int nt = (n + kT - 1) / kT;
  const long long body = static_cast<long long>(B) * tile_count(n);
  if (t >= body) return {static_cast<int>(t - body), -1, -1};
  const int b = static_cast<int>(t % B);
  int p = static_cast<int>(t / B) - 1, j = 0;
  if (p < 0) return {b, 0, 0};
  while (p >= nt - j) {
    p -= nt - j;
    ++j;
  }
  return p == 1 ? Task{b, j + 1, j + 1} : Task{b, j + (p ? p : 1), j};
}

__host__ __device__ __forceinline__ long long task_count(int n, int B) {
  return static_cast<long long>(B) * (tile_count(n) + 1);
}

// ints of the factor's workspace: the task counter, a failed flag an
// entry, a flag a tile (zeroed before each launch)
__host__ __device__ __forceinline__ size_t work_ints(int n, int B) {
  return 1 + static_cast<size_t>(B) * (1 + tile_count(n));
}

// ---------------------------------------------------------------------
// the factor
// ---------------------------------------------------------------------
template <typename T>
struct Slab {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));  // a chunk
  static constexpr int S = kKS + V;     // a row: an odd number of chunks
};

// The factor's choices by type, measured on an H100 at B = 64 (PERF.md
// §6).  f32: two blocks an SM (128 registers a thread); the tile's running
// value in shared memory during the update (its 16 partial sums, 16
// operands and the next slab in registers), and TRSM a column a step on
// the whole block (trsm_columns: 1.96 ms a factor at n = 1024 against
// 2.41 by a warp's rows, whose shuffle chains the other block's update
// starves).  f64: one block an SM; the running value in registers; TRSM
// by a warp's rows (trsm_rows: 0.318 ms at n = 365 against 0.437).
template <typename T> struct Design {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kMinBlocks = kF32 ? 2 : 1;
  static constexpr bool kAccShared = kF32;
  static constexpr bool kTrsmRows = !kF32;
};

template <typename T>
struct FactorSmem {
  union {
    struct {
      T a[2][kT * Slab<T>::S];
      T b[2][kT * Slab<T>::S];
    } slab;
    T diag[kT * (kT + 1)];              // L_jj, padded (TRSM)
  } u;
  // the tile's running value H_ij - sum L_ik L_jk^T (f32), padded rows
  T acc[Design<T>::kAccShared ? kT * (kT + 1) : 1];
  T rdiag[kT];                          // 1 / L_jj's diagonal
  T col[2][kT];                         // the column of the step
  int task;
};

// The POTRF of a diagonal task's tile S (shared memory, rows padded to
// kT + 1), by the block, in kPB-column steps.  Warp 0 factors the kPB x
// kPB diagonal block (lane r its row r, columns broadcast by shuffle; a
// column's pivot d = sqrt(a_kk) and the entries below it a_ik (1 / d),
// IEEE square root and division as LAPACK's potf2: rsqrt's approximation,
// which the other chol kernels keep, cost the tiled factor accuracy in
// f32) and keeps its diagonal's reciprocals; every warp solves the rows
// below it against it (rows independent: a half-warp a row, a lane a
// column, shuffles); every thread then updates its entries of the
// trailing lower triangle, k in increasing order.  Ten barriers for a
// 64-column tile.  Returns (in warp 0) whether a pivot of a row below
// `valid` was not positive.
constexpr int kPB = 16;

template <typename T>
__device__ __forceinline__ bool potrf_blocked(T* S, T* rdiag, int valid) {
  constexpr int P = kT + 1;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  bool bad = false;
#pragma unroll 1
  for (int k0 = 0; k0 < kT; k0 += kPB) {
    if (w == 0) {
      const int r = lane & (kPB - 1);    // lanes 16..31 repeat 0..15
      T row[kPB];
#pragma unroll
      for (int t = 0; t < kPB; ++t) row[t] = S[(k0 + r) * P + k0 + t];
#pragma unroll
      for (int k = 0; k < kPB; ++k) {
        const T piv = __shfl_sync(kFull, row[k], k);
        bad = bad || (k0 + k < valid && !(piv > T(0)));
        const T d = sqrt(piv);            // IEEE: as LAPACK's potf2
        const T c = r == k ? d : row[k] * (T(1) / d);
        row[k] = c;
#pragma unroll
        for (int t = k + 1; t < kPB; ++t)
          row[t] = fma(-c, __shfl_sync(kFull, c, t), row[t]);
      }
      if (lane < kPB) {
#pragma unroll
        for (int t = 0; t < kPB; ++t) S[(k0 + r) * P + k0 + t] = row[t];
      }
      __syncwarp();
      if (lane < kPB) rdiag[lane] = T(1) / S[(k0 + lane) * P + k0 + lane];
    }
    __syncthreads();
    const int rest = kT - k0 - kPB;
    if (rest <= 0) break;
    {
      // the panel below: rows k0 + kPB + 2 w + half + 16 m
      const int col = lane & (kPB - 1), half = lane >> 4;
      const T* D = S + k0 * P + k0;
      T d[kPB];
#pragma unroll
      for (int c = 0; c < kPB; ++c) d[c] = D[col * P + c];
      T v[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int rr = k0 + kPB + 2 * w + half + 16 * m;
        v[m] = rr < kT ? S[rr * P + k0 + col] : T(0);
      }
#pragma unroll
      for (int c = 0; c < kPB; ++c) {
        const T rd = rdiag[c];
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const T xc = __shfl_sync(kFull, v[m], c, kPB) * rd;
          if (col == c)
            v[m] = xc;
          else if (col > c)
            v[m] = fma(-xc, d[c], v[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int rr = k0 + kPB + 2 * w + half + 16 * m;
        if (rr < kT) S[rr * P + k0 + col] = v[m];
      }
    }
    __syncthreads();
    // the trailing lower triangle: rows and columns k0 + kPB .., a thread
    // (ty, tx) of 16 x 16 its entries k0 + kPB + ty + 16 a, .. + tx + 16 b
    const int base = k0 + kPB;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int r = base + ty + 16 * a, c = base + tx + 16 * b;
        if (r < kT && c <= r) {
          T e = S[r * P + c];
#pragma unroll
          for (int k = 0; k < kPB; ++k)
            e = fma(-S[r * P + k0 + k], S[c * P + k0 + k], e);
          S[r * P + c] = e;
        }
      }
    __syncthreads();
  }
  return bad;
}

// rows of a TRSM tile a warp (kT / 8 warps), a lane columns lane and
// lane + 32
constexpr int kRowsW = kT / (kThreads / 32);

// The TRSM of a task's tile X (x[q][h]: row kRowsW w + q, column lane +
// 32 h) against L_jj (D, padded rows; rdiag its diagonal's reciprocals):
// the rows are independent, so each warp runs its own column steps with
// shuffles and no block barrier: column c is x[:, c] times 1 / L_jj[c][c]
// (broadcast from its lane), and every later column takes -x[:, c]
// L_jj[col][c].
template <typename T>
__device__ __forceinline__ void trsm_rows(T (&x)[kRowsW][2], const T* D,
                                          const T* rdiag) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int hc = 0; hc < 2; ++hc) {
#pragma unroll 1
    for (int cc = 0; cc < 32; ++cc) {
      const int c = 32 * hc + cc;
      const T rd = rdiag[c];
      const T d0 = D[lane * (kT + 1) + c];
      const T d1 = D[(lane + 32) * (kT + 1) + c];
#pragma unroll
      for (int q = 0; q < kRowsW; ++q) {
        const T xc = __shfl_sync(kFull, x[q][hc], cc) * rd;
        if (hc == 0) {
          if (lane == cc)
            x[q][0] = xc;
          else if (lane > cc)
            x[q][0] = fma(-xc, d0, x[q][0]);
          x[q][1] = fma(-xc, d1, x[q][1]);
        } else {
          if (lane == cc)
            x[q][1] = xc;
          else if (lane > cc)
            x[q][1] = fma(-xc, d1, x[q][1]);
        }
      }
    }
  }
}

// TRSM on the whole block from acc, a column a step (f32, Design): the
// threads that own column c put it in col, one barrier, every thread takes
// its entries times 1 / L_jj[c][c] and updates its later columns by L_jj's
// column c (sm.u.diag, padded rows).
template <typename T>
__device__ __forceinline__ void trsm_columns(T (&acc)[4][4],
                                             FactorSmem<T>& sm) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int cb = 0; cb < 4; ++cb) {
#pragma unroll 1
    for (int cc = 0; cc < 16; ++cc) {
      const int c = 16 * cb + cc;
      T* col = sm.col[c & 1];
      if (tx == cc) {
#pragma unroll
        for (int a = 0; a < 4; ++a) col[ty + 16 * a] = acc[a][cb];
      }
      __syncthreads();
      const T s = sm.rdiag[c];
      T ci[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ci[a] = col[ty + 16 * a] * s;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int cx = tx + 16 * b;
        const T cj = sm.u.diag[cx * (kT + 1) + c];
        if (cx == c) {
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][b] = ci[a];
        } else if (cx > c) {
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][b] = fma(-ci[a], cj, acc[a][b]);
        }
      }
    }
  }
}

// One slab (kKS columns) of the k-tiles behind tile rows i and j into
// registers: a thread's rows ty + 16 m, column tx of the slab (a warp
// reads two rows' 16 entries together); rows past n are zero.
template <typename T>
__device__ __forceinline__ void load_slab(const T* __restrict__ Lb, int n,
                                          int r0, int c0, T (&v)[4]) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = r0 + ty + 16 * m;
    v[m] = r < n ? __ldcg(Lb + static_cast<size_t>(r) * n + c0 + tx) : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void store_slab(T* dst, const T (&v)[4]) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int m = 0; m < 4; ++m) dst[(ty + 16 * m) * Slab<T>::S + tx] = v[m];
}

// part += A B^T over one slab in shared memory, k in increasing order
template <typename T>
__device__ __forceinline__ void update_slab(T (&part)[4][4], const T* A,
                                            const T* Bm) {
  using VT = typename Vec<T>::type;
  constexpr int V = Slab<T>::V, S = Slab<T>::S;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int kk = 0; kk < kKS; kk += V) {
    VT bv[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      bv[b] = *reinterpret_cast<const VT*>(Bm + (tx + 16 * b) * S + kk);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const VT av = *reinterpret_cast<const VT*>(A + (ty + 16 * a) * S + kk);
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          part[a][b] = fma(reinterpret_cast<const T*>(&av)[v],
                           reinterpret_cast<const T*>(&bv[b])[v], part[a][b]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, Design<T>::kMinBlocks)
tiled_factor_kernel(const T* __restrict__ H, T* __restrict__ L,
                    int* __restrict__ work, int n, int B) {
  __shared__ __align__(16) FactorSmem<T> sm;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nt = (n + kT - 1) / kT, ntile = tile_count(n);
  const long long total = task_count(n, B);
  int* failed = work + 1;
  int* flags = work + 1 + B;
  for (;;) {
    if (tid == 0) sm.task = atomicAdd(work, 1);
    __syncthreads();
    const long long t = sm.task;
    __syncthreads();                  // before thread 0 takes the next
    if (t >= total) break;
    const Task tk = task_of(t, n, B);
    const size_t nn = static_cast<size_t>(n) * n;
    T* Lb = L + tk.b * nn;
    int* fl = flags + static_cast<size_t>(tk.b) * ntile;
    const bool stamp = tk.b == 0 && tid == 0;
    LSC_TSTAMP_DECL(t0);
    LSC_TSTAMP_DECL(tw);
    if (tk.i < 0) {                   // the entry's last task
      for (int p = tid; p < ntile; p += kThreads) wait_gpu(fl + p, 1);
      __syncthreads();
      if (ld_acquire_gpu(failed + tk.b)) {
        const T nan = nan_of<T>();
        for (int r = tid >> 5; r < n; r += kThreads / 32)
          for (int c = tid & 31; c <= r; c += 32)
            Lb[static_cast<size_t>(r) * n + c] = nan;
      }
      LSC_TSTAMP(stamp, kTsFinal, t0);
      continue;
    }
    const int i = tk.i, j = tk.j, I = i * kT, J = j * kT;
    const bool diag = i == j;
    LSC_TCOUNT(stamp, kTsTasks);
    // H's tile (identity past n on the diagonal: pivots of 1, no effect)
    const T* Hb = H + tk.b * nn;
    constexpr bool kAccShared = Design<T>::kAccShared;
    T acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = I + ty + 16 * a, c = J + tx + 16 * b;
        const T h = r < n && c < n ? __ldg(Hb + static_cast<size_t>(r) * n + c)
                                   : T(diag && r == c);
        if constexpr (kAccShared)
          sm.acc[(ty + 16 * a) * (kT + 1) + tx + 16 * b] = h;
        else
          acc[a][b] = h;
      }
    // the update, k = 0 .. j - 1, slab by slab, double-buffered: each
    // k-tile's sum L_ik L_jk^T in its own partial sums, then subtracted
    // (two levels: 64 terms, then j, not one chain of 64 j)
    const int slabs = j * (kT / kKS);
    if (slabs) {
      T va[4], vb[4], part[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) part[a][b] = T(0);
      wait_gpu(fl + tile_index(i, 0, nt), 1);
      if (!diag) wait_gpu(fl + tile_index(j, 0, nt), 1);
      LSC_TSTAMP(stamp, kTsWait, tw);
      load_slab(Lb, n, I, 0, va);
      if (!diag) load_slab(Lb, n, J, 0, vb);
      store_slab(sm.u.slab.a[0], va);
      if (!diag) store_slab(sm.u.slab.b[0], vb);
      __syncthreads();
      for (int s = 0; s < slabs; ++s) {
        const bool more = s + 1 < slabs;
        if (more) {
          const int k = (s + 1) / (kT / kKS);
          if ((s + 1) % (kT / kKS) == 0) {
            LSC_TSTAMP(stamp, kTsUpdate, tw);
            wait_gpu(fl + tile_index(i, k, nt), 1);
            if (!diag) wait_gpu(fl + tile_index(j, k, nt), 1);
            LSC_TSTAMP(stamp, kTsWait, tw);
            LSC_TCOUNT(stamp, kTsKTiles);
          }
          const int c0 = (s + 1) * kKS;
          load_slab(Lb, n, I, c0, va);
          if (!diag) load_slab(Lb, n, J, c0, vb);
        }
        const T* A = sm.u.slab.a[s & 1];
        update_slab(part, A, diag ? A : sm.u.slab.b[s & 1]);
        if ((s + 1) % (kT / kKS) == 0) {
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              if constexpr (kAccShared)
                sm.acc[(ty + 16 * a) * (kT + 1) + tx + 16 * b] -= part[a][b];
              else
                acc[a][b] -= part[a][b];
              part[a][b] = T(0);
            }
        }
        if (more) {
          store_slab(sm.u.slab.a[(s + 1) & 1], va);
          if (!diag) store_slab(sm.u.slab.b[(s + 1) & 1], vb);
        }
        __syncthreads();
      }
      LSC_TCOUNT(stamp, kTsKTiles);
    }
    LSC_TSTAMP(stamp, kTsUpdate, tw);
    LSC_TSTAMP_DECL(tp);
    if (diag) {
      T* S = kAccShared ? sm.acc : sm.u.diag;
      if constexpr (!kAccShared) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            S[(ty + 16 * a) * (kT + 1) + tx + 16 * b] = acc[a][b];
      }
      __syncthreads();
      if (potrf_blocked(S, sm.rdiag, n - J) && tid == 0) failed[tk.b] = 1;
      LSC_TSTAMP(stamp, kTsPotrf, tp);
      // the tile out (a warp's rows, coalesced), zeros above the diagonal
      const int lane = tid & 31, w = tid >> 5;
#pragma unroll
      for (int q = 0; q < kRowsW; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rt = kRowsW * w + q, ct = lane + 32 * h;
          if (I + rt < n && J + ct < n)
            Lb[static_cast<size_t>(I + rt) * n + J + ct] =
                ct > rt ? T(0) : S[rt * (kT + 1) + ct];
        }
    } else if constexpr (!Design<T>::kTrsmRows) {
      if constexpr (kAccShared) {         // a thread's own entries
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[a][b] = sm.acc[(ty + 16 * a) * (kT + 1) + tx + 16 * b];
      }
      LSC_TSTAMP_DECL(tq);
      wait_gpu(fl + tile_index(j, j, nt), 1);
      LSC_TSTAMP(stamp, kTsTrsmWait, tq);
#pragma unroll 4
      for (int e = tid; e < kT * kT; e += kThreads) {
        const int r = e >> 6, c = e & (kT - 1);
        sm.u.diag[r * (kT + 1) + c] =
            __ldcg(Lb + static_cast<size_t>(J + r) * n + J + c);
      }
      __syncthreads();
      if (tid < kT) sm.rdiag[tid] = T(1) / sm.u.diag[tid * (kT + 1) + tid];
      __syncthreads();
      trsm_columns(acc, sm);
      LSC_TSTAMP(stamp, kTsTrsm, tp);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int r = I + ty + 16 * a, c = J + tx + 16 * b;
          if (r < n) Lb[static_cast<size_t>(r) * n + c] = acc[a][b];
          const int rz = J + ty + 16 * a, cz = I + tx + 16 * b;
          if (cz < n) Lb[static_cast<size_t>(rz) * n + cz] = T(0);
        }
    } else {
      // the tile to a warp's rows (through shared memory), then L_jj
      // (final: its flag) and its reciprocals in its place
      const int lane = tid & 31, w = tid >> 5;
      T* X = sm.u.diag;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          X[(ty + 16 * a) * (kT + 1) + tx + 16 * b] = acc[a][b];
      __syncthreads();
      T x[kRowsW][2];
#pragma unroll
      for (int q = 0; q < kRowsW; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          x[q][h] = X[(kRowsW * w + q) * (kT + 1) + lane + 32 * h];
      __syncthreads();
      LSC_TSTAMP_DECL(tq);
      wait_gpu(fl + tile_index(j, j, nt), 1);
      LSC_TSTAMP(stamp, kTsTrsmWait, tq);
#pragma unroll 4
      for (int e = tid; e < kT * kT; e += kThreads) {
        const int r = e >> 6, c = e & (kT - 1);
        X[r * (kT + 1) + c] =
            __ldcg(Lb + static_cast<size_t>(J + r) * n + J + c);
      }
      __syncthreads();
      if (tid < kT) sm.rdiag[tid] = T(1) / X[tid * (kT + 1) + tid];
      __syncthreads();
      trsm_rows(x, X, sm.rdiag);
      LSC_TSTAMP(stamp, kTsTrsm, tp);
      // the tile out (a warp's rows, coalesced); tile (j, i)'s zeros
#pragma unroll
      for (int q = 0; q < kRowsW; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = I + kRowsW * w + q, c = J + lane + 32 * h;
          if (r < n) Lb[static_cast<size_t>(r) * n + c] = x[q][h];
          const int rz = J + kRowsW * w + q, cz = I + lane + 32 * h;
          if (cz < n) Lb[static_cast<size_t>(rz) * n + cz] = T(0);
        }
    }
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      st_release_gpu(fl + tile_index(i, j, nt), 1);
    }
    LSC_TSTAMP(stamp, kTsWrite, tp);
  }
}

// ---------------------------------------------------------------------
// the solve
// ---------------------------------------------------------------------

// The solve's block: 16 warps in f32 (15 streaming; 115 registers a
// thread), 8 in f64 (7 streaming: a forward streamer's 32 partial sums are
// doubles, more than 128 registers a thread hold beside its loads).
template <typename T> struct Solve {
  static constexpr int kWarps = sizeof(T) == 4 ? 16 : 8;
  static constexpr int kStreamers = kWarps - 1;
  static constexpr int kThreads = kWarps * 32;
};

// Bytes of the solve's dynamic shared memory at n: z (row blocks of kSB),
// two padded diagonal tiles, the streamers' partials (two slabs a
// direction), a counter a row block and direction, the two chain flags.
template <typename T>
__host__ __device__ __forceinline__ size_t solve_smem_bytes(int n) {
  const int nb = (n + kSB - 1) / kSB;
  return sizeof(T) * (static_cast<size_t>(nb) * kSB + 2 * kSB * (kSB + 1) +
                      4 * Solve<T>::kStreamers * kSB) +
         sizeof(int) * (2 * static_cast<size_t>(nb) + 2);
}

// One halving of reduce_scatter: lanes with bit D keep the upper D of the
// 2 D sums in a, the others the lower, each adding its partner's half.
template <int D, typename T>
__device__ __forceinline__ void halve(T (&a)[kSB], int lane) {
  const bool up = lane & D;
#pragma unroll
  for (int q = 0; q < D; ++q) {
    const T send = up ? a[q] : a[q + D];
    const T keep = up ? a[q + D] : a[q];
    a[q] = keep + __shfl_xor_sync(kFull, send, D);
  }
  if constexpr (D > 1) halve<D / 2>(a, lane);
}

// Sums a[t] over the warp's lanes, lane l returning the sum of a[l]
// (recursive halving: 31 shuffles, one fixed order).
template <typename T>
__device__ __forceinline__ T reduce_scatter(T (&a)[kSB]) {
  halve<kSB / 2>(a, threadIdx.x & 31);
  return a[0];
}

// Diagonal tile r (rows and columns r kSB ..) into registers, a lane a
// column (coalesced; zero past n), then into the padded tile D.
template <typename T>
__device__ __forceinline__ void load_diag(const T* __restrict__ Lb, int n,
                                          int r, T (&v)[kSB]) {
  const int lane = threadIdx.x & 31, c = r * kSB + lane;
#pragma unroll
  for (int t = 0; t < kSB; ++t) {
    const int row = r * kSB + t;
    v[t] = row < n && c < n ? Lb[static_cast<size_t>(row) * n + c] : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void store_diag(T* D, const T (&v)[kSB]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < kSB; ++t) D[t * (kSB + 1) + lane] = v[t];
  __syncwarp();
}

// rows loaded a time by a forward streamer (its registers: kSB partial
// sums and these)
template <typename T> struct Chunk {
  static constexpr int R = sizeof(T) == 4 ? kSB : kSB / 2;
};

template <typename T>
__global__ void __launch_bounds__(Solve<T>::kThreads, 1)
tiled_solve_kernel(const T* __restrict__ L, const T* __restrict__ rhs,
                   T* __restrict__ x, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStreamers = Solve<T>::kStreamers;
  constexpr int kSolveThreads = Solve<T>::kThreads;
  const int nb = (n + kSB - 1) / kSB;
  T* z = reinterpret_cast<T*>(smem);
  T* Dt = z + nb * kSB;                           // [2][kSB * (kSB + 1)]
  T* partf = Dt + 2 * kSB * (kSB + 1);            // [2][kStreamers][kSB]
  T* partb = partf + 2 * kStreamers * kSB;
  int* cntf = reinterpret_cast<int*>(partb + 2 * kStreamers * kSB);
  int* cntb = cntf + nb;
  int* zready = cntb + nb;                        // forward blocks solved
  int* xready = zready + 1;                       // backward blocks solved
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const size_t b = blockIdx.x;
  const T* Lb = L + b * static_cast<size_t>(n) * n;
  for (int e = tid; e < nb * kSB; e += kSolveThreads)
    z[e] = e < n ? rhs[b * n + e] : T(0);
  for (int e = tid; e < 2 * nb + 2; e += kSolveThreads) cntf[e] = 0;
  __syncthreads();
  const bool stamp = blockIdx.x == 0 && lane == 0;
  LSC_TSTAMP_DECL(t_all);
  LSC_TSTAMP_DECL(t0);
  if (w == 0) {
    // the chain: forward, then backward (tile r in Dt[r & 1]; the
    // forward's last tile is the backward's first)
    T v[kSB];
    load_diag(Lb, n, 0, v);
    store_diag(Dt, v);
    for (int r = 0; r < nb; ++r) {
      if (r + 1 < nb) load_diag(Lb, n, r + 1, v);
      LSC_TSTAMP(stamp, kTsChain, t0);
      if (r) wait_cta(cntf + r, kStreamers);
      LSC_TSTAMP(stamp, kTsChainWait, t0);
      const T* D = Dt + (r & 1) * kSB * (kSB + 1);
      const int row = r * kSB + lane;
      T acc = z[row];
      if (r)
        for (int s = 0; s < kStreamers; ++s)
          acc -= partf[((r & 1) * kStreamers + s) * kSB + lane];
      const T ri = row < n ? T(1) / D[lane * (kSB + 1) + lane] : T(0);
#pragma unroll
      for (int k = 0; k < kSB; ++k) {
        const T zk = __shfl_sync(kFull, acc * ri, k);
        if (lane == k) acc = zk;
        if (lane > k) acc -= D[lane * (kSB + 1) + k] * zk;
      }
      z[row] = acc;
      __syncwarp();
      if (lane == 0) st_release_cta(zready, r + 1);
      if (r + 1 < nb) store_diag(Dt + ((r + 1) & 1) * kSB * (kSB + 1), v);
    }
    for (int q = 0; q < nb; ++q) {
      const int r = nb - 1 - q;
      if (r) load_diag(Lb, n, r - 1, v);
      LSC_TSTAMP(stamp, kTsChain, t0);
      if (q) wait_cta(cntb + q, kStreamers);
      LSC_TSTAMP(stamp, kTsChainWait, t0);
      const T* D = Dt + (r & 1) * kSB * (kSB + 1);
      const int row = r * kSB + lane;
      T acc = z[row];
      if (q)
        for (int s = 0; s < kStreamers; ++s)
          acc -= partb[((q & 1) * kStreamers + s) * kSB + lane];
      const T ri = row < n ? T(1) / D[lane * (kSB + 1) + lane] : T(0);
#pragma unroll
      for (int k = kSB - 1; k >= 0; --k) {
        const T xk = __shfl_sync(kFull, acc * ri, k);
        if (lane == k) acc = xk;
        if (lane < k) acc -= D[k * (kSB + 1) + lane] * xk;
      }
      z[row] = acc;
      __syncwarp();
      if (lane == 0) st_release_cta(xready, q + 1);
      if (r) store_diag(Dt + ((r - 1) & 1) * kSB * (kSB + 1), v);
    }
    LSC_TSTAMP(stamp, kTsChain, t0);
  } else {
    const int sw = w - 1;
    constexpr int R = Chunk<T>::R;
    // forward: slab s (row block s), tiles c = sw, sw + kStreamers, ..
    // < s; a lane a column of the tile, a partial sum a row
    for (int s = 1; s < nb; ++s) {
      if (s >= 2) wait_cta(zready, s - 1);   // partf[s & 1] consumed
      T acc[kSB];
#pragma unroll
      for (int t = 0; t < kSB; ++t) acc[t] = T(0);
      for (int c = sw; c < s; c += kStreamers) {
        const T* tile = Lb + static_cast<size_t>(s) * kSB * n + c * kSB +
                        lane;
#pragma unroll
        for (int h = 0; h < kSB; h += R) {
          T v[R];
#pragma unroll
          for (int t = 0; t < R; ++t)
            v[t] = s * kSB + h + t < n
                       ? tile[static_cast<size_t>(h + t) * n] : T(0);
          if (h == 0) {
            LSC_TSTAMP(stamp, kTsStream, t0);
            wait_cta(zready, c + 1);
            LSC_TSTAMP(stamp, kTsStreamWait, t0);
          }
          const T zc = z[c * kSB + lane];
#pragma unroll
          for (int t = 0; t < R; ++t) acc[h + t] = fma(v[t], zc, acc[h + t]);
        }
      }
      const T p = reduce_scatter(acc);
      partf[((s & 1) * kStreamers + sw) * kSB + lane] = p;
      __syncwarp();
      if (lane == 0) red_release_cta(cntf + s, 1);
    }
    // backward: step q solves row block r = nb - 1 - q; tiles (c, r), c
    // = the streamer's, from the last down to r + 1; a lane a column of
    // the tile (a row of x)
    for (int q = 1; q < nb; ++q) {
      const int r = nb - 1 - q;
      if (q >= 2) wait_cta(xready, q - 1);   // partb[q & 1] consumed
      T acc = T(0);
      int c = (nb - 1) - ((nb - 1 - sw) % kStreamers + kStreamers) %
                             kStreamers;
      for (; c > r; c -= kStreamers) {
        const T* tile = Lb + static_cast<size_t>(c) * kSB * n + r * kSB +
                        lane;
        T v[kSB];
#pragma unroll
        for (int t = 0; t < kSB; ++t)
          v[t] = c * kSB + t < n ? tile[static_cast<size_t>(t) * n] : T(0);
        LSC_TSTAMP(stamp, kTsStream, t0);
        wait_cta(xready, nb - c);
        LSC_TSTAMP(stamp, kTsStreamWait, t0);
#pragma unroll
        for (int t = 0; t < kSB; ++t) acc = fma(v[t], z[c * kSB + t], acc);
      }
      partb[((q & 1) * kStreamers + sw) * kSB + lane] = acc;
      __syncwarp();
      if (lane == 0) red_release_cta(cntb + q, 1);
    }
    LSC_TSTAMP(stamp, kTsStream, t0);
  }
  __syncthreads();
  for (int e = tid; e < n; e += kSolveThreads) x[b * n + e] = z[e];
  LSC_TSTAMP(blockIdx.x == 0 && tid == 0, kTsSolve, t_all);
}

}  // namespace chol_tiled
