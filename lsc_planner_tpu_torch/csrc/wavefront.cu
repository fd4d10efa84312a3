// Batched 6-connected wavefront distance fields for the grid goal planner.
//
// Replaces lsc_planner_tpu/ops/wavefront_pallas.py::_wavefront_kernel
// (wavefront_pallas.py:28).  Same result, bit for bit and step counts
// included, as the TPU kernel's Jacobi loop and its plain version
// (ops/wavefront.py::wavefront_batched_plain): per agent, the unit-cost
// min-plus field out from the goal cell over a (Z, Y, X) occupancy grid
// (1 = blocked); the goal cell is free even when it is occupied;
// unreachable and blocked cells hold BIG = 1e9; the loop tests for a
// change after each group of 8 steps and stops when a group changed no
// cell, or at max_iters rounded up to a multiple of 8.
//
// Why breadth-first levels give the Jacobi loop's bits.  A Jacobi step
// sets a free cell to the least of itself and its neighbours + 1 (BIG + 1
// rounds to BIG in f32), so after t steps a cell holds its 6-connected
// BFS distance from the goal through free cells where that distance is
// <= t, and BIG elsewhere: integers below 2^24, exact in f32.  The levels
// are contiguous, so a group of 8 steps changes some cell exactly when a
// level lies in it.  With L the deepest level (0 when only the goal is
// reached, or the goal lies outside the grid), the loop runs
//   steps = 0                                          if max_iters <= 0
//   steps = min(8 ceil(L / 8) + 8, 8 ceil(max_iters / 8))   otherwise,
// and the field is the distance where it is <= steps, BIG elsewhere.  So
// the kernel runs the BFS, level by level, up to the capped step count.
//
// Bits, not floats.  Each (z, y) row of X cells is W = ceil(X / 64)
// 64-bit words.  Shared memory holds three bitsets: the free cells and
// the reached set, double-buffered, with a zero halo row on each side in
// y and z so that no neighbour read needs an edge test, word-major so
// that a warp's loads hit consecutive words.  A level is
//   new = (R | R << 1 | R >> 1 | R[y +- 1] | R[z +- 1]) & free & ~R,
// the shifts carrying across the words of a row (nothing crosses a row's
// ends: the bits past X are never free); each thread takes whole rows.
// Each bit new at level t writes t to the field in device memory; after
// the last level one coalesced pass writes BIG to every cell not reached,
// so each cell of the field is written once.  One barrier a level, which
// is also the "did the level add a cell" vote (__syncthreads_or).
//
// What bounds it on an H100: the function needs its occupancy read once
// and its field written once (8 bytes a cell) and one relaxation a reached
// cell, so bytes bound it: 3 MB, ~0.9 us, at forest20's 20 grids of
// (11, 41, 41).  The time is made of the levels themselves: each is a
// dependent pass behind a block barrier, and on a large grid its seven
// 8-byte shared-memory loads a word fill the shared-memory pipe.  The
// bitsets cut a level to a few word operations a row instead of a dozen
// float operations a cell, and the grid a block holds from 9 bytes a cell
// to 3 bits (24 bytes a row word, halo rows included; ops/wavefront.py
// computes the same limit).  No division in the level loop or in the
// per-word code: an integer division is a chain of ~20 dependent
// instructions, so rows step their (z, y) (the occupancy pass divides
// once a batch of kBatch row words).  One block of kThreads = 1024
// threads an agent (20 of the 132 SMs at forest20): at forest20's 473
// rows a level, one thread a row (480) measured 13 % slower on an H100,
// 128 threads 2x and one warp 6x slower (PERF.md's block-size
// readings).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (lsc_planner_tpu_torch/ops/_build.py).
// Interface: plain C, pointers to contiguous device memory, the CUDA
// stream as an opaque pointer; returns cudaGetLastError() (or the error of
// the shared-memory attribute call).

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;    // a block an agent
constexpr int kBatch = 8;       // row words a warp loads before its ballots
constexpr float kBig = 1e9f;
constexpr size_t kMaxSmem = 232448;   // 227 KB, the H100's per-block limit
constexpr size_t kWordBytes = 3 * sizeof(u64);   // free, reached x 2

// Words of one bitset: W word planes of (Z + 2) x (Y + 2) rows.
__host__ __device__ inline size_t bitset_words(int Z, int Y, int W) {
  return static_cast<size_t>(Z + 2) * (Y + 2) * W;
}

__global__ void __launch_bounds__(kThreads)
wavefront_kernel(const float* __restrict__ occ, const int* __restrict__ goal,
                 float* __restrict__ out, int* __restrict__ steps, int Z,
                 int Y, int X, int max_iters) {
  extern __shared__ __align__(16) u64 bits[];
  // word j of halo'd row (z + 1) * YP + y + 1 sits at j * R + that row:
  // word-major, so the threads of a warp, a row each, read consecutive
  // words (no bank conflicts); y +- 1 is +- 1, z +- 1 is +- YP, the next
  // word of the row + R
  const int W = (X + 63) >> 6, YP = Y + 2, R = (Z + 2) * YP;
  const int total = static_cast<int>(bitset_words(Z, Y, W));
  u64* free_ = bits;
  u64* cur = bits + total;
  u64* nxt = cur + total;
  constexpr int nthreads = kThreads, nwarps = kThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const size_t cells = static_cast<size_t>(Z) * Y * X;
  const float* occ_b = occ + b * cells;
  float* out_b = out + b * cells;
  const int gz = goal[3 * b], gy = goal[3 * b + 1], gx = goal[3 * b + 2];
  // a goal outside the grid matches no cell, as the TPU kernel's iota test
  const bool has_goal = gz >= 0 && gz < Z && gy >= 0 && gy < Y && gx >= 0 &&
                        gx < X;
  const int g_row = gz * Y + gy;

  for (int i = tid; i < 3 * total; i += nthreads) bits[i] = 0;
  __syncthreads();
  // the free bits, a warp a run of kBatch row words (64 cells each): the
  // run's loads in flight at once, 32 cells a coalesced load, then two
  // ballots a word; row, word, z and y step along the run
  const int RW = Z * Y * W;
  for (int rw0 = warp * kBatch; rw0 < RW; rw0 += nwarps * kBatch) {
    const int r0 = rw0 / W, j0 = rw0 - r0 * W;
    float v[kBatch][2];
    int r = r0, j = j0;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int x0 = 64 * j + lane;
      const float* row = occ_b + static_cast<size_t>(r) * X;
      const bool in = rw0 + k < RW;
      v[k][0] = in && x0 < X ? row[x0] : 1.0f;
      v[k][1] = in && x0 + 32 < X ? row[x0 + 32] : 1.0f;
      if (++j == W) j = 0, ++r;
    }
    int z = r0 / Y, y = r0 - z * Y;
    r = r0, j = j0;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (rw0 + k >= RW) break;               // the same in the whole warp
      const int x0 = 64 * j + lane;
      const bool goal_row = has_goal && r == g_row;
      const unsigned lo = __ballot_sync(
          kFull, x0 < X && (!(v[k][0] > 0.5f) || (goal_row && x0 == gx)));
      const unsigned hi = __ballot_sync(
          kFull, x0 + 32 < X &&
                     (!(v[k][1] > 0.5f) || (goal_row && x0 + 32 == gx)));
      if (lane == 0)
        free_[j * R + (z + 1) * YP + y + 1] =
            static_cast<u64>(lo) | static_cast<u64>(hi) << 32;
      if (++j == W) {
        j = 0, ++r;
        if (++y == Y) y = 0, ++z;
      }
    }
  }
  if (tid == 0 && has_goal) {
    cur[(gx >> 6) * R + (gz + 1) * YP + gy + 1] = 1ull << (gx & 63);
    out_b[static_cast<size_t>(g_row) * X + gx] = 0.0f;
  }
  __syncthreads();

  // levels 1, 2, ... up to the loop's cap; rows of planes 1..Z (their y
  // halo rows included: nothing there is free, so nothing changes)
  const long long cap =
      max_iters <= 0 ? 0 : 8 * ((static_cast<long long>(max_iters) + 7) / 8);
  const int r_end = (Z + 1) * YP;
  // a thread's rows are YP + tid + k * nthreads; their halo'd (z, y) step
  // by (dz, dy), with no division
  const int dz = nthreads / YP, dy = nthreads - dz * YP;
  const int zp0 = 1 + tid / YP, yp0 = tid - (zp0 - 1) * YP;
  int deepest = 0;
  for (int t = 1; t <= cap; ++t) {
    int added = 0;
    int zp = zp0, yp = yp0;
    for (int r = YP + tid; r < r_end; r += nthreads) {
      u64 left = 0;                           // bit 63 of the word before
      u64 c = cur[r];
      for (int j = 0, i = r; j < W; ++j, i += R) {
        const u64 c_next = j + 1 < W ? cur[i + R] : 0;
        const u64 reach = c | c << 1 | c >> 1 | left | c_next << 63 |
                          cur[i - 1] | cur[i + 1] | cur[i - YP] |
                          cur[i + YP];
        const u64 fresh = reach & free_[i] & ~c;
        nxt[i] = c | fresh;
        if (fresh) {
          added = 1;
          float* o = out_b + (static_cast<size_t>(zp - 1) * Y + yp - 1) * X +
                     64 * j;
          const float level = static_cast<float>(t);
          for (u64 m = fresh; m; m &= m - 1) o[__ffsll(m) - 1] = level;
        }
        left = c >> 63;
        c = c_next;
      }
      yp += dy, zp += dz;
      if (yp >= YP) yp -= YP, ++zp;
    }
    if (!__syncthreads_or(added)) break;
    deepest = t;
    u64* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // BIG wherever the BFS did not reach, a warp a row (coalesced); cur is
  // the final reached set either way the loop ended
  const int wz = nwarps / Y, wy = nwarps - wz * Y;
  for (int r = warp, z = warp / Y, y = warp - z * Y; r < Z * Y;
       r += nwarps, y += wy, z += wz) {
    if (y >= Y) y -= Y, ++z;
    const u64* c = cur + (z + 1) * YP + y + 1;
    float* o = out_b + static_cast<size_t>(r) * X;
    for (int x = lane; x < X; x += 32)
      if (!((c[(x >> 6) * R] >> (x & 63)) & 1ull)) o[x] = kBig;
  }
  if (tid == 0) {
    const long long run = 8 * ((static_cast<long long>(deepest) + 7) / 8) + 8;
    steps[b] = static_cast<int>(run < cap ? run : cap);
  }
}

}  // namespace

extern "C" {

// occ (N, Z, Y, X) f32, goal (N, 3) int32 (z, y, x) -> out (N, Z, Y, X)
// f32, steps (N,) int32 relaxation steps the Jacobi loop runs.
int lsc_wavefront_f32(const void* occ, const void* goal, void* out,
                      void* steps, int N, int Z, int Y, int X, int max_iters,
                      void* stream) {
  if (N < 0 || Z < 1 || Y < 1 || X < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  const size_t bytes = kWordBytes * bitset_words(Z, Y, (X + 63) / 64);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wavefront_kernel<<<N, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(occ), static_cast<const int*>(goal),
      static_cast<float*>(out), static_cast<int*>(steps), Z, Y, X,
      max_iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
