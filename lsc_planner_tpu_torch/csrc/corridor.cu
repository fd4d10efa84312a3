// Safe Flight Corridor face expansion: each agent's seed box grows one
// voxel face at a time, round-robin over its six faces, until every face
// is blocked.
//
// Replaces the JAX package's per-agent lax.while_loop in
// lsc_planner_tpu/world/corridor.py:103-169 (CorridorBuilder.expand_box,
// vmapped by expand_boxes), itself the reference's expand_box
// (corridor_constructor.hpp:184-232).  It is not a Pallas kernel: on the
// TPU the loop is XLA's; here it is one launch a cycle in place of the
// port's batched PyTorch loop (ops/corridor.py::expand_boxes_plain),
// which dispatched ~20 small ops an iteration for hundreds of iterations.
//
// One thread an agent runs its round-robin to the end, the plain
// version's per-agent semantics step for step:
//   * the next active face slot strictly after the last one tried
//     (cyclic over six, starting after slot 5);
//   * the one-voxel expansion of that face, and the swept slab between
//     the old and the new face;
//   * the slab's obstruction test, OccupancySAT.box_obstructed
//     (world/esdf.py): eight inclusion-exclusion terms, each an eight-
//     corner summed-area count, with the low face's "at the world
//     minimum" flag compared in float32 (ops/corridor.py::at_world_min);
//   * the in-bounds test in the working dtype T, slab corner * res
//     against the world bounds -/+ eps, as ops/corridor.py::try_expand
//     computes it;
//   * the slot stays active iff the expansion succeeded; the loop ends
//     when no slot is active.
// Every step is integer lattice arithmetic except the two bound tests,
// which take the same roundings as the plain version's PyTorch ops (the
// scalar cast to the tensor's dtype, one rounded product, one rounded
// sum; __f*_rn/__d*_rn keep nvcc from contracting them), so the boxes are
// the plain version's bit for bit.  A seed whose box is obstructed
// (seed_ok false) keeps its box.  Each success grows a box inside the
// world's finite lattice and each face fails once, so every thread ends.
//
// What bounds it on an H100: latency.  A try reads 64 SAT entries (int32,
// through the read-only path; a forest20 SAT is ~1 MB and stays in L2)
// and a box takes ~10-200 tries, one after the other.  The agents are
// independent threads of one or a few warps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (lsc_planner_tpu_torch/ops/_build.py).
// Interface: plain C, pointers to contiguous device memory, the CUDA
// stream as an opaque pointer; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // agents a block

struct Sat {
  const int* __restrict__ sat;   // (S0, S1, S2) int32 prefix counts
  long long dims[3];             // S - 1: the grid's cells an axis
  long long s1, s2;              // row strides of the flat index
  long long k0[3];               // the grid's origin key
};

__device__ __forceinline__ long long clampll(long long v, long long hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// OccupancySAT._box_count: occupied cells in the cell box [lo, hi]
// inclusive (grid-local), 0 when empty or out of range.  Corner c takes
// hi on axis a when bit a of c is set; its sign is (-1)^(3 - set bits).
__device__ __forceinline__ long long box_count(const Sat& s,
                                               const long long lo[3],
                                               const long long hi[3]) {
  long long lc[3], hc[3];
  bool empty = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lc[a] = clampll(lo[a], s.dims[a]);
    hc[a] = clampll(hi[a] + 1, s.dims[a]);
    empty |= hc[a] <= lc[a];
  }
  if (empty) return 0;
  long long total = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const long long x = (c & 1) ? hc[0] : lc[0];
    const long long y = (c & 2) ? hc[1] : lc[1];
    const long long z = (c & 4) ? hc[2] : lc[2];
    const long long v = __ldg(s.sat + (x * s.s1 + y) * s.s2 + z);
    total += (__popc(c) & 1) ? v : -v;   // (-1)^(3 - popcount)
  }
  return total;
}

// OccupancySAT.box_obstructed over absolute lattice corners: per axis the
// sampled cells are {lo-1} u [lo+1, hi] away from the world minimum and
// [lo, hi] at it; term m fixes the axes of its set bits to the excluded
// plane [lo, lo] (sign (-1)^(set bits)), and a bound axis has no excluded
// plane, so its terms vanish.
__device__ __forceinline__ bool obstructed(const Sat& s, const int lo_abs[3],
                                           const int hi_abs[3],
                                           const bool at_min[3]) {
  long long lo[3], hi[3], a[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = static_cast<long long>(lo_abs[k]) - s.k0[k];
    hi[k] = static_cast<long long>(hi_abs[k]) - s.k0[k];
    a[k] = lo[k] - 1 + (at_min[k] ? 1 : 0);
  }
  long long total = 0;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    bool valid = true;
    long long t_lo[3], t_hi[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const bool bit = (m >> k) & 1;
      valid &= !(bit && at_min[k]);
      t_lo[k] = bit ? lo[k] : a[k];
      t_hi[k] = bit ? lo[k] : hi[k];
    }
    if (!valid) continue;
    const long long cnt = box_count(s, t_lo, t_hi);
    total += (__popc(m) & 1) ? -cnt : cnt;
  }
  return total > 0;
}

template <typename T> __device__ T mul_rn(T a, T b);
template <> __device__ float mul_rn<float>(float a, float b) {
  return __fmul_rn(a, b);
}
template <> __device__ double mul_rn<double>(double a, double b) {
  return __dmul_rn(a, b);
}
template <typename T> __device__ T add_rn(T a, T b);
template <> __device__ float add_rn<float>(float a, float b) {
  return __fadd_rn(a, b);
}
template <> __device__ double add_rn<double>(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const int* __restrict__ lo0, const int* __restrict__ hi0,
              const long long* __restrict__ cand,
              const bool* __restrict__ seed_ok, Sat s,
              const float* __restrict__ wmin32, const T* __restrict__ wmin,
              const T* __restrict__ wmax, double res, double eps,
              double eps_f, int* __restrict__ lo_out,
              int* __restrict__ hi_out, int N) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= N) return;
  int lo[3], hi[3], c[6];
  // the bounds as the plain version forms them: the Python scalars cast
  // to the tensor's dtype, then one rounded op
  float at_min_thr[3];
  T lo_thr[3], hi_thr[3];
  const float res_f = static_cast<float>(res);
  const T res_t = static_cast<T>(res);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = lo0[3 * i + k];
    hi[k] = hi0[3 * i + k];
    at_min_thr[k] = __fadd_rn(wmin32[k], static_cast<float>(eps_f));
    lo_thr[k] = add_rn<T>(wmin[k], -static_cast<T>(eps));
    hi_thr[k] = add_rn<T>(wmax[k], static_cast<T>(eps));
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) c[j] = static_cast<int>(cand[6 * i + j]);
  unsigned active = seed_ok[i] ? 0x3fu : 0u;
  int p = 5;
  while (active) {
    // the next active slot strictly after p, cyclically
    int p2 = p;
#pragma unroll
    for (int j = 6; j >= 1; --j) {
      const int slot = (p + j) % 6;
      if ((active >> slot) & 1u) p2 = slot;
    }
    const int axis6 = c[p2];
    const int ax = axis6 % 3;
    const bool high = axis6 >= 3;
    int lo_n[3], hi_n[3], s_lo[3], s_hi[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int one = (k == ax) ? 1 : 0;
      lo_n[k] = high ? lo[k] : lo[k] - one;
      hi_n[k] = high ? hi[k] + one : hi[k];
      // update slab: old face -> new face along ax, full elsewhere
      s_lo[k] = (k == ax) ? (high ? hi[k] : lo_n[k]) : lo_n[k];
      s_hi[k] = (k == ax) ? (high ? hi_n[k] : lo[k]) : hi_n[k];
    }
    bool at_min[3];
    bool inb = true;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      at_min[k] = __fmul_rn(static_cast<float>(s_lo[k]), res_f) <=
                  at_min_thr[k];
      inb &= mul_rn<T>(static_cast<T>(s_lo[k]), res_t) > lo_thr[k];
      inb &= mul_rn<T>(static_cast<T>(s_hi[k]), res_t) < hi_thr[k];
    }
    const bool ok = inb && !obstructed(s, s_lo, s_hi, at_min);
    if (ok) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lo[k] = lo_n[k];
        hi[k] = hi_n[k];
      }
    } else {
      active &= ~(1u << p2);
    }
    p = p2;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo_out[3 * i + k] = lo[k];
    hi_out[3 * i + k] = hi[k];
  }
}

template <typename T>
int launch_expand(const void* lo0, const void* hi0, const void* cand,
                  const void* seed_ok, const void* sat, int S0, int S1,
                  int S2, long long k0x, long long k0y, long long k0z,
                  const void* wmin32, const void* wmin, const void* wmax,
                  double res, double eps, double eps_f, void* lo_out,
                  void* hi_out, int N, void* stream) {
  if (N < 0 || S0 < 1 || S1 < 1 || S2 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  Sat s;
  s.sat = static_cast<const int*>(sat);
  s.dims[0] = S0 - 1;
  s.dims[1] = S1 - 1;
  s.dims[2] = S2 - 1;
  s.s1 = S1;
  s.s2 = S2;
  s.k0[0] = k0x;
  s.k0[1] = k0y;
  s.k0[2] = k0z;
  const int blocks = (N + kThreads - 1) / kThreads;
  expand_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lo0), static_cast<const int*>(hi0),
      static_cast<const long long*>(cand), static_cast<const bool*>(seed_ok),
      s, static_cast<const float*>(wmin32), static_cast<const T*>(wmin),
      static_cast<const T*>(wmax), res, eps, eps_f,
      static_cast<int*>(lo_out), static_cast<int*>(hi_out), N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// lo0, hi0 (N, 3) int32 absolute lattice corners; cand (N, 6) int64 face
// slots; seed_ok (N,) bool; sat (S0, S1, S2) int32 with origin key k0;
// wmin32 (3,) f32; wmin, wmax (3,) in the working dtype; res, eps (the
// in-bounds epsilon), eps_f (the float32 at-minimum epsilon) -> lo_out,
// hi_out (N, 3) int32.
int lsc_expand_boxes_f32(const void* lo0, const void* hi0, const void* cand,
                         const void* seed_ok, const void* sat, int S0, int S1,
                         int S2, long long k0x, long long k0y, long long k0z,
                         const void* wmin32, const void* wmin,
                         const void* wmax, double res, double eps,
                         double eps_f, void* lo_out, void* hi_out, int N,
                         void* stream) {
  return launch_expand<float>(lo0, hi0, cand, seed_ok, sat, S0, S1, S2, k0x,
                              k0y, k0z, wmin32, wmin, wmax, res, eps, eps_f,
                              lo_out, hi_out, N, stream);
}

int lsc_expand_boxes_f64(const void* lo0, const void* hi0, const void* cand,
                         const void* seed_ok, const void* sat, int S0, int S1,
                         int S2, long long k0x, long long k0y, long long k0z,
                         const void* wmin32, const void* wmin,
                         const void* wmax, double res, double eps,
                         double eps_f, void* lo_out, void* hi_out, int N,
                         void* stream) {
  return launch_expand<double>(lo0, hi0, cand, seed_ok, sat, S0, S1, S2, k0x,
                               k0y, k0z, wmin32, wmin, wmax, res, eps, eps_f,
                               lo_out, hi_out, N, stream);
}

}  // extern "C"
