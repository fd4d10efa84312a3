// Batched 6-connected wavefront distance fields for the grid goal planner.
//
// Replaces lsc_planner_tpu/ops/wavefront_pallas.py::_wavefront_kernel.
// Same semantics, bit for bit: per agent, the unit-cost min-plus distance
// field out from the goal cell over a (Z, Y, X) occupancy grid (1 =
// blocked); the goal cell is free even when it is occupied; unreachable
// and blocked cells hold BIG = 1e9.  Jacobi relaxation: every step reads
// the previous step's field only (two buffers, never in place), and the
// convergence test runs after each group of 8 steps: the loop stops when a
// group changed no cell, or when the step count reaches max_iters (so at
// max_iters rounded up to a multiple of 8).  The distances are integers
// below 2^24 and BIG + 1 rounds to BIG in float32, so the field is exact
// and equals the TPU kernel's and the plain version's bit for bit.
//
// What bounds it on an H100: latency.  One agent's field at the forest
// grid (Z, Y, X) = (11, 41, 41) is 18,491 cells; a step is ~12 operations
// a cell, so even the 144 steps of the cap are ~3.2e7 operations and 74 KB
// in + 74 KB out an agent -- microseconds of the card's FLOP and byte
// rates.  The time is made of the steps themselves: each is a dependent
// stencil pass over the whole grid behind a block barrier.  The design
// keeps the whole relaxation on chip, as the TPU kernel keeps it in VMEM:
// one thread block an agent, both f32 buffers and one byte of occupancy a
// cell in shared memory (9 bytes a cell: 166 KB at the forest grid, under
// the 227 KB a block may hold), threads striding over the cells, one
// barrier a step, and the group's "any cell changed" as __syncthreads_or.
// Device memory is read once and written once an agent.  Splitting one
// grid over a cluster, and several steps a barrier by temporal tiling, are
// later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (lsc_planner_tpu_torch/ops/_build.py).
// Interface: plain C, pointers to contiguous device memory, the CUDA
// stream as an opaque pointer; returns cudaGetLastError() (or the error of
// the shared-memory attribute call).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr float kBig = 1e9f;
constexpr size_t kMaxSmem = 232448;   // 227 KB, the H100's per-block limit

__global__ void __launch_bounds__(kThreads)
wavefront_kernel(const float* __restrict__ occ, const int* __restrict__ goal,
                 float* __restrict__ out, int* __restrict__ steps, int Z,
                 int Y, int X, int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cells = Z * Y * X;
  float* cur = reinterpret_cast<float*>(smem);
  float* nxt = cur + cells;
  unsigned char* blocked = reinterpret_cast<unsigned char*>(nxt + cells);
  const size_t b = blockIdx.x;
  const int gz = goal[3 * b], gy = goal[3 * b + 1], gx = goal[3 * b + 2];
  // a goal outside the grid matches no cell, as the TPU kernel's iota test
  const int g = (gz >= 0 && gz < Z && gy >= 0 && gy < Y && gx >= 0 &&
                 gx < X) ? (gz * Y + gy) * X + gx : -1;
  const float* occ_b = occ + b * cells;
  for (int e = threadIdx.x; e < cells; e += blockDim.x) {
    blocked[e] = (occ_b[e] > 0.5f) && e != g;
    cur[e] = e == g ? 0.0f : kBig;
  }
  __syncthreads();

  const int YX = Y * X;
  int i = 0;
  int changed = 1;
  while (i < max_iters && changed) {
    int flag = 0;
    for (int s = 0; s < 8; ++s) {
      for (int e = threadIdx.x; e < cells; e += blockDim.x) {
        const float here = cur[e];
        float v = kBig;
        if (!blocked[e]) {
          const int z = e / YX;
          const int r = e - z * YX;
          const int y = r / X;
          const int x = r - y * X;
          v = here;
          // the TPU kernel's order: x+1, x-1, y+1, y-1, z+1, z-1
          v = fminf(v, (x < X - 1 ? cur[e + 1] : kBig) + 1.0f);
          v = fminf(v, (x > 0 ? cur[e - 1] : kBig) + 1.0f);
          v = fminf(v, (y < Y - 1 ? cur[e + X] : kBig) + 1.0f);
          v = fminf(v, (y > 0 ? cur[e - X] : kBig) + 1.0f);
          v = fminf(v, (z < Z - 1 ? cur[e + YX] : kBig) + 1.0f);
          v = fminf(v, (z > 0 ? cur[e - YX] : kBig) + 1.0f);
        }
        // values never rise, so "a step lowered a cell" over the group is
        // the TPU kernel's any(D_new < D) across its 8 steps
        flag |= v < here;
        nxt[e] = v;
      }
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    changed = __syncthreads_or(flag);
    i += 8;
  }

  float* out_b = out + b * cells;
  for (int e = threadIdx.x; e < cells; e += blockDim.x) out_b[e] = cur[e];
  if (threadIdx.x == 0) steps[b] = i;
}

}  // namespace

extern "C" {

// occ (N, Z, Y, X) f32, goal (N, 3) int32 (z, y, x) -> out (N, Z, Y, X)
// f32, steps (N,) int32 relaxation steps run.
int lsc_wavefront_f32(const void* occ, const void* goal, void* out,
                      void* steps, int N, int Z, int Y, int X, int max_iters,
                      void* stream) {
  if (N < 0 || Z < 1 || Y < 1 || X < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  const size_t cells = static_cast<size_t>(Z) * Y * X;
  const size_t bytes = cells * (2 * sizeof(float) + 1);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  wavefront_kernel<<<N, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(occ), static_cast<const int*>(goal),
      static_cast<float*>(out), static_cast<int*>(steps), Z, Y, X, max_iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
