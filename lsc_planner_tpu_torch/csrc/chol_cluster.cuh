// Large-n batched Cholesky on Hopper: one thread-block cluster a matrix,
// the lower triangle resident in the cluster's distributed shared memory.
//
// Replaces, for 64 < n and the shapes whose factor a cluster of one or two
// blocks holds (csrc/chol.cu::cluster_plan), lsc_planner_tpu/ops/
// chol_pallas.py::_factor_solve_kernel, ::_resolve_kernel and
// ::_chol_kernel; chol.cu's one-block kernels take the shapes past that.
// Same semantics: right-looking lower Cholesky with no pivot floor,
// forward then backward substitution, a non-SPD entry NaN in its own
// batch entry only (its lower triangle and its x), the factor returned
// row-major (B, n, n) with zeros above the diagonal.
//
// What bounds it on an H100: at the slack QP's B = 64, n = 365 in f32 the
// bytes (H in, L out: 68 MB, ~20 us) and the f32 operations (1.0e9, ~15
// us) are small; the factor is a chain of 12 dependent 32-wide panel
// steps and the substitutions a chain of 24 diagonal solves, so latency
// bounds it: each step's one-warp diagonal factor, panel solve and
// synchronisation.  The design keeps every step on chip:
//
// - L is cut into 32 x 32 tiles.  Block r of a cluster of G holds a
//   contiguous range of tile rows (Geo; G the smallest of 1 and 2 that
//   holds the tiles and the buffers in 227 KB a block, kMaxG: 2 at n =
//   359-384 in f32, 128 blocks on 132 SMs at B = 64).  H's lower tiles
//   come in once (cp.async, many loads in flight); each tile of L goes
//   out once, as soon as it is final.
// - A tile is stored transposed (column t's 32 entries together), its
//   16-byte chunks XOR-swizzled (sw()), so that a chunk of a column is one
//   16-byte load and the warps' access patterns avoid bank conflicts.
// - Step k: the owner of tile row k has factored the diagonal tile (one
//   warp, factor_tile: warp_chol::factor's arithmetic, the column passed
//   through shared memory) and pushed it and its reciprocals into the
//   shared memory of the later blocks (those that hold rows below it);
//   every warp of the cluster solves one tile of the panel below it (a
//   lane a row) and pushes it into the later blocks; the warp of panel
//   tile (k + 1, k) updates diagonal tile k + 1 at once; after a cluster
//   barrier the trailing update is a register-tiled FMA product from
//   shared memory (4 x 8 accumulators a lane, 8 x 8 on pairs of tile rows
//   in f32; no TF32), while one warp factors diagonal tile k + 1
//   (look-ahead).  Two cluster barriers a step, no trip through device
//   memory; a split one (arrive before H's load, wait after it) before
//   the first push, so that every block of the cluster has started
//   before a mate writes into it.
// - The substitutions run from the resident tiles (cluster_solve), a
//   warp a tile row, with flags instead of barriers: block scope inside a
//   block, cluster scope between blocks (G - 1 hops each way).  resolve
//   loads L's lower tiles into the same layout, takes the reciprocals as
//   1 / L[i][i] (the bits the factor keeps) and runs the same function,
//   so it returns factor_solve's x bit for bit; the factor alone stops
//   before the solve (kSolve), so it returns factor_solve's L bit for bit.
// - Every sum has one order fixed by the code (no atomics on data,
//   nothing that depends on scheduling), so the results are deterministic
//   and a captured launch gives the uncaptured bits.
//
// Built with -DLSC_CHOL_STAMPS, the kernels add clock64() intervals of
// the first matrix's blocks into lsc_chol_stamps (the split of the time
// by phase: scripts/kernel_bits_torch.py split); off in the normal build.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "warp_chol.cuh"

namespace chol_cluster {

namespace cg = cooperative_groups;

constexpr int kT = 32;                   // tile edge
constexpr int kTE = kT * kT;             // entries a tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// Blocks a cluster, at most: 2 in the package's build (at B = 64 a
// cluster of 4 or 8 a matrix needs two or four waves of blocks on an
// H100's 132 SMs, and its kernels ran slower than the one-block ones,
// PERF.md); a measurement build may set LSC_CHOL_MAX_G to 0 (the one-block
// kernels at every large n), 4 or 8.
#ifndef LSC_CHOL_MAX_G
#define LSC_CHOL_MAX_G 2
#endif
constexpr int kMaxG = LSC_CHOL_MAX_G;
constexpr int kMaxNt = 32;               // tile rows, at most (n <= 1024)
// bytes before the entries: the failed flag (16), then the solve's flags
// (ints): z_a here (kMaxNt), x_a here (kMaxNt), block r's partial for row
// a here (kMaxNt x kMaxG)
constexpr int kFlags = 2 * kMaxNt + kMaxNt * kMaxG;
constexpr int kHdr = 16 + 4 * kFlags;
constexpr size_t kSmemCap = 232448;      // 227 KB, a block's most

// the clock stamps: cycles (kStTiles a count), summed over the first
// matrix's blocks.  Intervals of a block's thread 0: the load, the waits
// in the factor's cluster barriers, L out, the substitutions, the total.
// Work of the warps, summed over them: the diagonal factors, the panel
// tiles' solves (with their pushes and L out), the trailing tile updates
// (the look-ahead's included) and their number, the solve's waits on its
// flags and its publishing (fence and flags).
enum Stamp { kStLoad, kStDiag, kStPanel, kStTrail, kStTiles, kStSync,
             kStWrite, kStFwd, kStBwd, kStWait, kStPublish, kStTotal,
             kStamps };

#ifdef LSC_CHOL_STAMPS
__device__ unsigned long long lsc_chol_stamps[kStamps];
#define LSC_STAMP_DECL(t) long long t = clock64()
#define LSC_STAMP(on, slot, t)                                            \
  do {                                                                    \
    if (on) {                                                             \
      const long long now_ = clock64();                                   \
      atomicAdd(&chol_cluster::lsc_chol_stamps[slot],                     \
                static_cast<unsigned long long>(now_ - (t)));             \
      (t) = now_;                                                         \
    }                                                                     \
  } while (0)
#define LSC_COUNT(on, slot)                                               \
  do {                                                                    \
    if (on) atomicAdd(&chol_cluster::lsc_chol_stamps[slot], 1ull);        \
  } while (0)
#else
#define LSC_STAMP_DECL(t) ((void)0)
#define LSC_STAMP(on, slot, t) ((void)0)
#define LSC_COUNT(on, slot) ((void)0)
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

template <typename T>
struct Sw {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));  // a chunk
  static constexpr int C = kT / V;                            // a column
};

// Where entry (row i, column t) of a tile lives in it: column t's 16-byte
// chunk i / V XOR-swizzled by t mod C and by (C / 4) (t / C), entries in
// order within a chunk.  A warp reading one column (lanes over rows) hits
// 32 distinct banks, one reading a row (lanes over columns) 8 (4-way), a
// quarter-warp of update_tile's chunk loads of S 8 distinct chunks.
template <typename T>
__device__ __forceinline__ int sw(int t, int i) {
  constexpr int V = Sw<T>::V, C = Sw<T>::C;
  return t * kT + (((i / V) ^ (t % C) ^ (C / 4) * (t / C)) * V) + i % V;
}

// Rows q V .. q V + V - 1 of column t of a tile, from one 16-byte load.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* tile, int t, int q,
                                           T* out) {
  using VT = typename Vec<T>::type;
  const VT v = *reinterpret_cast<const VT*>(tile + sw<T>(t, q * Sw<T>::V));
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int s = 0; s < Sw<T>::V; ++s) out[s] = e[s];
}

template <typename T>
__device__ __forceinline__ void store_chunk(T* tile, int t, int q,
                                            const T* in) {
  using VT = typename Vec<T>::type;
  VT v;
  T* e = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int s = 0; s < Sw<T>::V; ++s) e[s] = in[s];
  *reinterpret_cast<VT*>(tile + sw<T>(t, q * Sw<T>::V)) = v;
}

// The tiles of a matrix over its cluster.  Block r holds the tile rows
// lo(r) .. hi(r) - 1, a contiguous range (the solve then crosses between
// blocks G - 1 times each way), cut where the tiles before it reach r / G
// of the lower triangle's; row a holds tiles (a, 0..a).  Shared memory of
// every block, in entries of T after kHdr bytes (the flags): the
// reciprocals of the diagonal (nt kT), a tile-sized buffer D (the pushed
// diagonal tile, the factor's scratch columns, the solve's vector z), the
// solve's partials of this block's rows (kT for each row and block), the
// block's own tiles, then one slot an earlier block's tile row c >= 1
// (the pushed panel tile (c, k); only later blocks read a row's panel
// tiles).  Everything a cluster-mate writes or reads lies at the same
// offset in every block.
struct Geo {
  int n, nt, G, rank;
  int lo_, hi_, max_rows;                // this block's rows; the most

  __device__ __host__ Geo(int n_, int G_, int rank_)
      : n(n_), nt((n_ + kT - 1) / kT), G(G_), rank(rank_) {
    lo_ = lo(rank);
    hi_ = hi(rank);
    max_rows = 0;
    for (int r = 0; r < G; ++r)
      max_rows = hi(r) - lo(r) > max_rows ? hi(r) - lo(r) : max_rows;
  }
  // block r's first row: the smallest a whose rows before hold at least
  // r / G of the tiles (no array: the cut is computed where it is used)
  __device__ __host__ int lo(int r) const {
    int a = 0;
    while (a < nt && a * (a + 1) * G < r * nt * (nt + 1)) ++a;
    return a;
  }
  __device__ __host__ int hi(int r) const { return r + 1 < G ? lo(r + 1) : nt; }
  __device__ __host__ int owner(int a) const {
    const int r = a * (a + 1) * G / (nt * (nt + 1));
    return r < G - 1 ? r : G - 1;
  }
  __device__ __host__ bool mine(int a) const { return a >= lo_ && a < hi_; }
  __device__ __host__ int rows_of(int r) const { return hi(r) - lo(r); }
  __device__ __host__ int tiles_of(int r) const {
    return (hi(r) * (hi(r) + 1) - lo(r) * (lo(r) + 1)) / 2;
  }
  // rows 1 <= c < lo(r) of earlier blocks, and the slot of such a row c
  // in block r
  __device__ __host__ int slots_of(int r) const {
    return lo(r) > 1 ? lo(r) - 1 : 0;
  }
  __device__ __host__ int slot(int, int c) const { return c - 1; }
  // offsets in entries of T from the start of the entries
  __device__ __host__ size_t d_off() const {
    return static_cast<size_t>(nt) * kT;
  }
  // block r's partial for row a (in a's owner)
  __device__ __host__ size_t part_off(int a, int r) const {
    return d_off() + kTE +
           static_cast<size_t>((a - lo(owner(a))) * G + r) * kT;
  }
  __device__ __host__ size_t tiles_off() const {
    return d_off() + kTE + static_cast<size_t>(max_rows) * G * kT;
  }
  __device__ __host__ size_t tile_off(int a, int c) const {
    const int l = lo(owner(a));
    return tiles_off() +
           static_cast<size_t>((a * (a + 1) - l * (l + 1)) / 2 + c) * kTE;
  }
  __device__ __host__ size_t slot_off(int r, int c) const {
    return tiles_off() +
           static_cast<size_t>(tiles_of(r) + slot(r, c)) * kTE;
  }
  // shared-memory bytes of block r: the factor (with the slots) or the
  // resolve (without)
  __host__ __device__ size_t smem_bytes(int r, bool slots,
                                        size_t elem) const {
    return kHdr + (tiles_off() + static_cast<size_t>(
        tiles_of(r) + (slots ? slots_of(r) : 0)) * kTE) * elem;
  }
};

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T)),
               "r"(valid ? static_cast<int>(sizeof(T)) : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The solve's flags: a warp's writes (here or in a cluster-mate) made
// visible at cluster scope before lane 0 sets a flag, and a flag awaited
// with acquire loads by every lane.
__device__ __forceinline__ void fence_cluster() {
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void flag_set(int* f) {
  asm volatile("st.relaxed.cluster.u32 [%0], %1;\n" ::"l"(f), "r"(1)
               : "memory");
}

__device__ __forceinline__ void fence_block() {
  asm volatile("fence.acq_rel.cta;\n" ::: "memory");
  __syncwarp();
}

__device__ __forceinline__ void flag_set_block(int* f) {
  asm volatile("st.relaxed.cta.u32 [%0], %1;\n" ::"l"(f), "r"(1)
               : "memory");
}

// A cluster barrier in two halves: every thread arrives, and later waits
// for every thread of the cluster to have arrived (no ordering of memory:
// it only shows that every block has started).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ void flag_wait(const int* f) {
  for (;;) {
    int v;
    asm volatile("ld.acquire.cluster.u32 %0, [%1];\n"
                 : "=r"(v) : "l"(f) : "memory");
    if (v) break;
    __nanosleep(32);
  }
  __syncwarp();
}

// The lower tiles of this block's tile rows of the row-major n x n matrix
// M into the tile layout, zeros past n; waits for the copies.
template <typename T>
__device__ void load_tiles(const Geo& g, const T* __restrict__ M, T* E) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int rows = g.rows_of(g.rank) * kT;
  for (int q = w; q < rows; q += kWarps) {
    const int a = g.lo_ + q / kT, i = q % kT, r = a * kT + i;
    T* row0 = E + g.tile_off(a, 0);
    const T* src = M + static_cast<size_t>(r < g.n ? r : 0) * g.n;
#pragma unroll 4
    for (int col = lane; col < (a + 1) * kT; col += 32) {
      const bool ok = r < g.n && col < g.n;
      cp_async(row0 + (col / kT) * kTE + sw<T>(col % kT, i),
               ok ? src + col : M, ok);
    }
  }
  cp_async_wait_all();
}

// A final tile (a, c) out to the row-major n x n matrix M: a warp, a
// lane a column, one 128-byte store a row (entries past n skipped; the
// tile holds zeros above the diagonal where M wants them).
template <typename T>
__device__ __forceinline__ void store_tile(const Geo& g, const T* tile,
                                           int a, int c, T* M) {
  const int lane = threadIdx.x & 31, col = c * kT + lane;
  if (col >= g.n) return;
  for (int i = 0; i < kT && a * kT + i < g.n; ++i)
    M[static_cast<size_t>(a * kT + i) * g.n + col] = tile[sw<T>(lane, i)];
}

// One warp: the lower Cholesky factor of the kb x kb tile in place (zeros
// above the diagonal and past kb), with warp_chol::factor's arithmetic:
// no pivot floor, L[j][k] = A[j][k] rsqrt(pivot) (the hardware
// reciprocal square root), each later column updated by one FMA per
// column in order, the reciprocals 1 / L[i][i].  Lane i holds row i in
// registers; column k passes through shared memory (the scratch column
// buf, two alternating), where every lane reads the pivot and the rows
// below it with 16-byte loads and scales them itself: no shuffle on the
// column chain.  Returns whether a pivot was not positive (the same in
// every lane); rinv: lane i's 1 / L[i][i] (0 past kb).
template <typename T>
__device__ bool factor_tile(T* tile, int kb, T* buf, T& rinv) {
  constexpr int V = Sw<T>::V;
  const int lane = threadIdx.x & 31;
  T R[kT];
#pragma unroll
  for (int j = 0; j < kT; ++j)
    R[j] = lane < kb && j <= lane ? tile[sw<T>(j, lane)] : T(0);
  bool failed = false;
  T diag = T(0);
#pragma unroll
  for (int k = 0; k < kT; ++k) {
    if (k >= kb) break;
    T* col = buf + (k & 1) * kT;
    col[lane] = R[k];                      // column k, every row
    __syncwarp();
    const T piv = col[k];
    failed = failed || !(piv > T(0));
    const T inv = warp_chol::rsqrt_of(piv);
    const T lik = R[k] * inv;              // L[lane][k]
    if (lane == k) diag = lik;
    tile[sw<T>(k, lane)] = lane >= k && lane < kb ? lik : T(0);
#pragma unroll
    for (int q = (k + 1) / V; q < kT / V; ++q) {
      using VT = typename Vec<T>::type;
      const VT v = *reinterpret_cast<const VT*>(col + q * V);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int u = 0; u < V; ++u)
        if (q * V + u > k) R[q * V + u] -= lik * (e[u] * inv);
    }
  }
  __syncwarp();
  rinv = lane < kb ? T(1) / diag : T(0);
  return failed;
}

// One warp factors diagonal tile k (its trailing updates done): the
// factor in place and out to L, the reciprocals into rinv, the flag set
// on a pivot <= 0 or NaN; then, when a panel follows, the tile and its
// reciprocals pushed into the D and rinv of each later block (the blocks
// that hold rows below it).
template <typename T>
__device__ void factor_diag(const Geo& g, int k, T* E, T* L, int* failed,
                            cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31;
  const int kb = min(kT, g.n - k * kT);
  T* tile = E + g.tile_off(k, k);
  T r0;
  const bool bad = factor_tile(tile, kb, E + g.d_off(), r0);
  E[k * kT + lane] = r0;
  if (bad && lane == 0) *failed = 1;
  if (k + 1 < g.nt) {
    for (int r = g.rank + 1; r < g.G; ++r) {
      T* D = cluster.map_shared_rank(E + g.d_off(), r);
#pragma unroll 4
      for (int j = 0; j < kT; ++j) D[sw<T>(j, lane)] = tile[sw<T>(j, lane)];
      cluster.map_shared_rank(E, r)[k * kT + lane] = r0;
    }
  }
  __syncwarp();
  store_tile(g, tile, k, k, L);
}

// S -= A B^T for 32 x 32 tiles (S = tile (a, c), A = (a, k), B = (c, k)):
// lane (ly, lx) holds rows 4 ly .. 4 ly + 3 and columns 8 lx .. 8 lx + 7
// of S in registers and streams column t of A and B from shared memory,
// one 16-byte load a chunk; each entry's sum runs over t in order.  The t
// loop stays rolled (4 a turn): fully unrolled, a tile took longer on the
// card (PERF.md §6).
template <typename T>
__device__ __forceinline__ void update_tile(T* S, const T* A, const T* B) {
  constexpr int V = Sw<T>::V;
  const int lane = threadIdx.x & 31, ly = lane >> 2, lx = lane & 3;
  T acc[4][8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    T c[4];
#pragma unroll
    for (int h = 0; h < 4 / V; ++h)
      load_chunk(S, 8 * lx + s, 4 * ly / V + h, c + h * V);
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r][s] = c[r];
  }
#pragma unroll 4
  for (int t = 0; t < kT; ++t) {
    T x[4], y[8];
#pragma unroll
    for (int h = 0; h < 4 / V; ++h)
      load_chunk(A, t, 4 * ly / V + h, x + h * V);
#pragma unroll
    for (int h = 0; h < 8 / V; ++h)
      load_chunk(B, t, 8 * lx / V + h, y + h * V);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 8; ++s) acc[r][s] -= x[r] * y[s];
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    T c[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) c[r] = acc[r][s];
#pragma unroll
    for (int h = 0; h < 4 / V; ++h)
      store_chunk(S, 8 * lx + s, 4 * ly / V + h, c + h * V);
  }
}

// S1 -= A1 B^T and S2 -= A2 B^T (tiles (a, c) and (a', c) of two of this
// block's tile rows): update_tile's arithmetic on both, B's loads shared,
// so each loaded entry feeds 8 products instead of 5.3.
template <typename T>
__device__ __forceinline__ void update_pair(T* S1, T* S2, const T* A1,
                                            const T* A2, const T* B) {
  constexpr int V = Sw<T>::V;
  const int lane = threadIdx.x & 31, ly = lane >> 2, lx = lane & 3;
  T acc[8][8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    T c[8];
#pragma unroll
    for (int h = 0; h < 4 / V; ++h) {
      load_chunk(S1, 8 * lx + s, 4 * ly / V + h, c + h * V);
      load_chunk(S2, 8 * lx + s, 4 * ly / V + h, c + 4 + h * V);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r][s] = c[r];
  }
#pragma unroll 2
  for (int t = 0; t < kT; ++t) {
    T x[8], y[8];
#pragma unroll
    for (int h = 0; h < 4 / V; ++h) {
      load_chunk(A1, t, 4 * ly / V + h, x + h * V);
      load_chunk(A2, t, 4 * ly / V + h, x + 4 + h * V);
    }
#pragma unroll
    for (int h = 0; h < 8 / V; ++h)
      load_chunk(B, t, 8 * lx / V + h, y + h * V);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int s = 0; s < 8; ++s) acc[r][s] -= x[r] * y[s];
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    T c[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) c[r] = acc[r][s];
#pragma unroll
    for (int h = 0; h < 4 / V; ++h) {
      store_chunk(S1, 8 * lx + s, 4 * ly / V + h, c + h * V);
      store_chunk(S2, 8 * lx + s, 4 * ly / V + h, c + 4 + h * V);
    }
  }
}

// The panel below diagonal tile k, this block's tiles (a, k), a > k: a
// warp a tile, a lane a row, v = a L_kk^-T right-looking with the kept
// reciprocals; each tile pushed into the later blocks' slot of row a
// (the blocks whose trailing tiles (a', a) read it) and out to L.
template <typename T>
__device__ void panel_solve(const Geo& g, int k, T* E, T* L,
                            cg::cluster_group& cluster, bool stamp) {
  constexpr int V = Sw<T>::V, C = Sw<T>::C;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const T* Lkk = g.mine(k) ? E + g.tile_off(k, k) : E + g.d_off();
  const T* rk = E + k * kT;
  // this block's tile rows past k
  const int a0 = k + 1 > g.lo_ ? k + 1 : g.lo_;
  for (int a = a0 + w; a < g.hi_; a += kWarps) {
    LSC_STAMP_DECL(t0);
    T* P = E + g.tile_off(a, k);
    T v[kT];
#pragma unroll
    for (int j = 0; j < kT; ++j) v[j] = P[sw<T>(j, lane)];
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      v[j] *= rk[j];
#pragma unroll
      for (int q = (j + 1) / V; q < C; ++q) {
        T c[V];
        load_chunk(Lkk, j, q, c);            // L_kk[q V + e][j]
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (q * V + e > j) v[q * V + e] -= v[j] * c[e];
      }
    }
#pragma unroll
    for (int j = 0; j < kT; ++j) P[sw<T>(j, lane)] = v[j];
    for (int r = g.rank + 1; r < g.G; ++r) {
      T* S = cluster.map_shared_rank(E + g.slot_off(r, a), r);
#pragma unroll
      for (int j = 0; j < kT; ++j) S[sw<T>(j, lane)] = v[j];
    }
    __syncwarp();
    store_tile(g, P, a, k, L);
    LSC_STAMP(stamp && lane == 0, kStPanel, t0);
    if (a == k + 1) {          // look-ahead: the next diagonal tile now
      update_tile(E + g.tile_off(a, a), P, P);
      LSC_STAMP(stamp && lane == 0, kStTrail, t0);
      LSC_COUNT(stamp && lane == 0, kStTiles);
    }
  }
}

// Step k's trailing update of this block's tiles (a, c), k < c <= a, a
// warp a work item: in f32 the tiles of two consecutive tile rows of this
// block that share a column go as a pair (update_pair), the others alone.
// Look-ahead: diagonal tile k + 1 was updated by the warp that solved
// panel tile (k + 1, k) (panel_solve); the owner's warp 0 factors it here
// while the other warps take the other items first.  A tile's arithmetic
// is the same alone or in a pair.
template <typename T>
__device__ void trailing(const Geo& g, int k, T* E, T* L, int* failed,
                         cg::cluster_group& cluster, bool stamp) {
  constexpr bool kPairs = sizeof(T) == 4;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const bool ahead = g.mine(k + 1);
  if (ahead && w == 0) {       // its panel warp updated the tile
    LSC_STAMP_DECL(t0);
    factor_diag(g, k + 1, E, L, failed, cluster);
    LSC_STAMP(stamp && lane == 0, kStDiag, t0);
  }
  const int turn = ahead ? (w + kWarps - 1) % kWarps : w;
  auto B = [&](int c) -> const T* {
    return g.mine(c) ? E + g.tile_off(c, k) : E + g.slot_off(g.rank, c);
  };
  int j = 0;
  // this block's tile rows past k (past k + 1 when it is the look-ahead's)
  int a = k + 1 > g.lo_ ? k + 1 : g.lo_;
  if (ahead) a += 1;
  for (; a < g.hi_; a += kPairs ? 2 : 1) {
    const int a2 = a + 1;               // the row paired with a
    const bool pair = kPairs && a2 < g.hi_;
    for (int c = k + 1; c <= (pair ? a2 : a); ++c) {
      if (j++ % kWarps != turn) continue;
      LSC_STAMP_DECL(t0);
      bool paired = false;
      if constexpr (kPairs) {
        if (pair && c <= a) {
          update_pair(E + g.tile_off(a, c), E + g.tile_off(a2, c),
                      E + g.tile_off(a, k), E + g.tile_off(a2, k), B(c));
          LSC_COUNT(stamp && lane == 0, kStTiles);
          paired = true;
        }
      }
      if (!paired) {
        const int row = c <= a ? a : a2;
        update_tile(E + g.tile_off(row, c), E + g.tile_off(row, k), B(c));
      }
      LSC_STAMP(stamp && lane == 0, kStTrail, t0);
      LSC_COUNT(stamp && lane == 0, kStTiles);
    }
  }
}

// The substitutions, from the resident tiles of every block: a block's
// warp w takes its tile rows a = w mod kWarps.  Forward, a row of this
// block: z_a -= L_ak z_k for k < a in order, each z_k awaited on its
// flag, then z_a = L_aa^-1 z_a (the kept reciprocals), its flag set in
// this block and z_a pushed with its flag into the later blocks.
// Backward, each row c below this block's last: this block's partial P_c
// = sum of L_jc^T x_j over its rows j > c (descending), each x_j awaited
// on its flag; an earlier block's row takes it by a push, this block's
// own row takes z_c -= P_c, then the later blocks' partials in order, and
// x_c = L_cc^-T z_c.  Every tile read is local; a hop between blocks only
// where a block's rows end, and no barrier.

// one warp, lane j: z_j -= sum_t L[j][t] z_k[t] for tile (a, k) (four
// partial sums), z_k from shared memory
template <typename T>
__device__ __forceinline__ T gemv_fwd(const T* A, const T* zk, T za) {
  const int lane = threadIdx.x & 31;
  T p[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 1
  for (int t = 0; t < kT; t += 4)
#pragma unroll
    for (int u = 0; u < 4; ++u) p[u] += A[sw<T>(t + u, lane)] * zk[t + u];
  return za - ((p[0] + p[1]) + (p[2] + p[3]));
}

// one warp, lane j: sum_i L[i][j] x[i] for tile (j', c) (a lane a column)
template <typename T>
__device__ __forceinline__ T gemv_bwd(const T* A, const T* x) {
  const int lane = threadIdx.x & 31;
  T p[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 1
  for (int i = 0; i < kT; i += 4)
#pragma unroll
    for (int u = 0; u < 4; ++u) p[u] += A[sw<T>(lane, i + u)] * x[i + u];
  return (p[0] + p[1]) + (p[2] + p[3]);
}

// z_k = L_kk^-1 z_k in place (z_k: kT entries of shared memory), and
// x_k = L_kk^-T z_k: one warp, lane j holding z_j; each unknown, times
// its kept reciprocal, passes to the other lanes through z_k (the
// column loop rolled, nothing indexed in registers).
template <typename T>
__device__ __forceinline__ void diag_fwd(int kb, const T* Lkk, const T* ri,
                                         T* zk) {
  const int lane = threadIdx.x & 31;
  T zr = zk[lane];
  const T r = ri[lane];
#pragma unroll 2
  for (int t = 0; t < kb; ++t) {
    const T l = Lkk[sw<T>(t, lane)];              // L[lane][t]
    if (lane == t) zk[t] = zr * r;
    __syncwarp();
    const T xt = zk[t];
    if (lane == t) zr = xt;
    else if (lane > t) zr -= l * xt;
  }
  zk[lane] = zr;
  __syncwarp();
}

template <typename T>
__device__ __forceinline__ void diag_bwd(int kb, const T* Lkk, const T* ri,
                                         T* zk) {
  const int lane = threadIdx.x & 31;
  T zr = zk[lane];
  const T r = ri[lane];
#pragma unroll 2
  for (int t = kb - 1; t >= 0; --t) {
    const T l = Lkk[sw<T>(lane, t)];              // L[t][lane]
    if (lane == t) zk[t] = zr * r;
    __syncwarp();
    const T xt = zk[t];
    if (lane == t) zr = xt;
    else if (lane < t) zr -= l * xt;
  }
  zk[lane] = zr;
  __syncwarp();
}

// Solves (L L^T) x = rhs: on entry z (D) holds this block's rows of the
// right-hand side and the flags are 0 in every block (a cluster barrier
// since they were zeroed); x out for this block's rows (NaN where bad).
// Every thread of the cluster calls it; ends with a cluster barrier.
template <typename T>
__device__ void cluster_solve(const Geo& g, T* E, int* flags,
                              T* __restrict__ x, bool bad,
                              cg::cluster_group& cluster, bool stamp,
                              bool wstamp) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int lo = g.lo_, hi = g.hi_;
  const bool ws = wstamp && lane == 0;
  T* z = E + g.d_off();
  int* fz = flags;                      // z_a is here
  int* fx = flags + kMaxNt;             // x_a is here (this block's rows)
  int* fp = flags + 2 * kMaxNt;         // block r's partial of row a
  LSC_STAMP_DECL(t0);
  for (int a = lo; a < hi; ++a) {                   // forward
    if (a % kWarps != w) continue;
    T za = z[a * kT + lane];
    for (int k = 0; k < a; ++k) {
      LSC_STAMP_DECL(tw);
      flag_wait(fz + k);
      LSC_STAMP(ws, kStWait, tw);
      za = gemv_fwd(E + g.tile_off(a, k), z + k * kT, za);
    }
    z[a * kT + lane] = za;
    __syncwarp();
    LSC_STAMP_DECL(td);
    diag_fwd(min(kT, g.n - a * kT), E + g.tile_off(a, a), E + a * kT,
             z + a * kT);
    LSC_STAMP(ws, kStDiag, td);
    LSC_STAMP_DECL(tp);
    fence_block();            // this block's later rows first
    if (lane == 0) flag_set_block(fz + a);
    if (g.rank + 1 < g.G) {   // then the later blocks'
      za = z[a * kT + lane];
      for (int r = g.rank + 1; r < g.G; ++r)
        cluster.map_shared_rank(z, r)[a * kT + lane] = za;
      fence_cluster();
      __syncwarp();
      if (lane == 0)
        for (int r = g.rank + 1; r < g.G; ++r)
          flag_set(cluster.map_shared_rank(fz + a, r));
    }
    LSC_STAMP(ws, kStPublish, tp);
  }
  __syncthreads();
  LSC_STAMP(stamp, kStFwd, t0);
  const T nan = nan_of<T>();
  // backward: every row c below this block's last (an earlier block's
  // row takes this block's partial; the later blocks' rows have none)
  for (int c = hi - 1 - ((hi - 1 - w) % kWarps + kWarps) % kWarps; c >= 0;
       c -= kWarps) {
    T part = T(0);                      // this block's rows past c
    for (int j = hi - 1; j > c && j >= lo; --j) {
      LSC_STAMP_DECL(tw);
      flag_wait(fx + j);
      LSC_STAMP(ws, kStWait, tw);
      part += gemv_bwd(E + g.tile_off(j, c), z + j * kT);
    }
    if (c < lo) {             // an earlier block's row: the partial to it
      LSC_STAMP_DECL(tp);
      const int o = g.owner(c);
      cluster.map_shared_rank(E + g.part_off(c, g.rank), o)[lane] = part;
      fence_cluster();
      __syncwarp();
      if (lane == 0)
        flag_set(cluster.map_shared_rank(fp + c * kMaxG + g.rank, o));
      LSC_STAMP(ws, kStPublish, tp);
      continue;
    }
    T zc = z[c * kT + lane];  // this block's, then the later blocks'
    zc -= part;
    for (int r = g.rank + 1; r < g.G; ++r) {
      LSC_STAMP_DECL(tw);
      flag_wait(fp + c * kMaxG + r);
      LSC_STAMP(ws, kStWait, tw);
      zc -= E[g.part_off(c, r) + lane];
    }
    z[c * kT + lane] = zc;
    __syncwarp();
    LSC_STAMP_DECL(td);
    diag_bwd(min(kT, g.n - c * kT), E + g.tile_off(c, c), E + c * kT,
             z + c * kT);
    LSC_STAMP(ws, kStDiag, td);
    zc = z[c * kT + lane];
    if (c * kT + lane < g.n) x[c * kT + lane] = bad ? nan : zc;
    fence_block();
    if (lane == 0) flag_set_block(fx + c);
  }
  LSC_STAMP(stamp, kStBwd, t0);
  cluster.sync();            // no block leaves while a mate writes to it
}

// factor_solve (kSolve) and the factor alone: one cluster of G blocks a
// matrix (see the note at the top).  Without kSolve, rhs and x are not
// read.
template <typename T, bool kSolve>
__global__ void __launch_bounds__(kThreads, 1)
cluster_factor_kernel(const T* __restrict__ H, const T* __restrict__ rhs,
                      T* __restrict__ L_out, T* __restrict__ x, int n,
                      int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Geo g(n, G, static_cast<int>(cluster.block_rank()));
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const size_t b = blockIdx.x / G;
  const size_t nn = static_cast<size_t>(n) * n;
  int* failed = reinterpret_cast<int*>(smem);
  int* flags = reinterpret_cast<int*>(smem + 16);
  T* E = reinterpret_cast<T*>(smem + kHdr);
  T* Lb = L_out + b * nn;
  const bool stamp = b == 0 && tid == 0;
  const bool wstamp = b == 0;                // the warps' own work
  LSC_STAMP_DECL(t0);
  LSC_STAMP_DECL(t_all);
  if (tid == 0) *failed = 0;
  for (int i = tid; i < kFlags; i += kThreads) flags[i] = 0;
  cluster_arrive_relaxed();  // this block has started
  const int rows = g.rows_of(g.rank) * kT;
  // the zeros right of this block's diagonal tiles, while H comes in
  for (int q = w; q < rows; q += kWarps) {
    const int a = g.lo_ + q / kT, r = a * kT + q % kT;
    if (r < n)
      for (int col = (a + 1) * kT + lane; col < n; col += 32)
        Lb[static_cast<size_t>(r) * n + col] = T(0);
  }
  load_tiles(g, H + b * nn, E);
  __syncthreads();
  LSC_STAMP(stamp, kStLoad, t0);
  {
    LSC_STAMP_DECL(ts);
    cluster_wait();          // every block started: pushes may go out
    LSC_STAMP(stamp, kStSync, ts);
  }
  if (g.mine(0) && w == 0) {
    LSC_STAMP_DECL(td);
    factor_diag(g, 0, E, Lb, failed, cluster);
    LSC_STAMP(wstamp && lane == 0, kStDiag, td);
  }
  for (int k = 0; k + 1 < g.nt; ++k) {
    {
      LSC_STAMP_DECL(ts);
      cluster.sync();        // diagonal k factored and pushed; step k - 1
      LSC_STAMP(stamp, kStSync, ts);
    }
    panel_solve(g, k, E, Lb, cluster, wstamp);
    {
      LSC_STAMP_DECL(ts);
      cluster.sync();        // panel k in every block that reads it
      LSC_STAMP(stamp, kStSync, ts);
    }
    trailing(g, k, E, Lb, failed, cluster, wstamp);
  }
  cluster.sync();
  LSC_STAMP_DECL(tw);
  int bad = 0;
  for (int r = 0; r < G; ++r) bad |= *cluster.map_shared_rank(failed, r);
  if (bad) {                  // this block's lower triangle all NaN
    const T nan = nan_of<T>();
    for (int q = w; q < rows; q += kWarps) {
      const int r = g.lo_ * kT + q;
      if (r < n)
        for (int col = lane; col <= r; col += 32)
          Lb[static_cast<size_t>(r) * n + col] = nan;
    }
  }
  LSC_STAMP(stamp, kStWrite, tw);
  if constexpr (kSolve) {
    T* z = E + g.d_off();
    for (int q = tid; q < rows; q += kThreads) {
      const int r = g.lo_ * kT + q;
      z[r] = r < n ? rhs[b * n + r] : T(0);
    }
    __syncthreads();
    cluster_solve(g, E, flags, x + b * n, bad, cluster, stamp, wstamp);
  } else {
    cluster.sync();          // no block leaves while a mate reads it
  }
  LSC_STAMP(stamp, kStTotal, t_all);
}

// resolve: L's lower tiles into the factor's layout, the reciprocals as
// factor() keeps them (1 / L[i][i]), and factor_solve's substitutions.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
cluster_resolve_kernel(const T* __restrict__ L, const T* __restrict__ rhs,
                       T* __restrict__ x, int n, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Geo g(n, G, static_cast<int>(cluster.block_rank()));
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x / G;
  const T* Lb = L + b * static_cast<size_t>(n) * n;
  int* flags = reinterpret_cast<int*>(smem + 16);
  T* E = reinterpret_cast<T*>(smem + kHdr);
  T* z = E + g.d_off();
  const bool stamp = b == 0 && tid == 0;
  LSC_STAMP_DECL(t0);
  LSC_STAMP_DECL(t_all);
  for (int i = tid; i < kFlags; i += kThreads) flags[i] = 0;
  const int rows = g.rows_of(g.rank) * kT;
  for (int q = tid; q < rows; q += kThreads) {
    const int r = g.lo_ * kT + q;
    E[r] = r < n ? T(1) / Lb[static_cast<size_t>(r) * n + r] : T(0);
    z[r] = r < n ? rhs[b * n + r] : T(0);
  }
  load_tiles(g, Lb, E);
  __syncthreads();
  cluster.sync();            // every block's flags zeroed
  LSC_STAMP(stamp, kStLoad, t0);
  cluster_solve(g, E, flags, x + b * n, false, cluster, stamp, b == 0);
  LSC_STAMP(stamp, kStTotal, t_all);
}

}  // namespace chol_cluster
