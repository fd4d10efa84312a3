// Safe Flight Corridor face expansion: each agent's seed box grows one
// voxel face at a time, round-robin over its six faces, until every face
// is blocked.
//
// Replaces the JAX package's per-agent lax.while_loop in
// lsc_planner_tpu/world/corridor.py:103-169 (CorridorBuilder.expand_box,
// vmapped by expand_boxes), itself the reference's expand_box
// (corridor_constructor.hpp:184-232).  It is not a Pallas kernel: on the
// TPU the loop is XLA's; here it is one launch a cycle in place of the
// port's batched PyTorch loop (ops/corridor.py::expand_boxes_plain).
//
// The function, the plain version's per-agent semantics step for step:
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
//
// Design (one warp an agent, kWarps agents a block, no block barrier):
//   * a round speculates K = LSC_CORRIDOR_K tries (8 in the package's
//     build, chosen by measurement; measurement builds take 1, 4 or 6
//     through -DLSC_CORRIDOR_K, ops/_build.py::load_variant).
//     Until a try fails the active slots do not change, so try j of the
//     round is the slot of rank j % n in the cyclic order of the n active
//     slots after the last slot tried, and the box it is cut from is the
//     box grown by j / n whole turns of the active slots and the slots
//     ranked before j % n (Order, order_at: popcounts, no loop over the
//     tries before it);
//   * the warp's lanes form groups of P = 8 (K = 4) or 4 (K = 6, 8)
//     lanes, one a try: a lane cuts its try's slab, tests its bounds and
//     takes 8 / P of the slab's eight inclusion-exclusion terms, eight
//     corner reads a term, so every read of the round (K x 64) is issued
//     before any is used.  A term dropped at the world minimum, or whose
//     cell box is empty, reads its clamped (legal) corners all the same
//     and carries a zero sign, so no branch stands between the loads;
//   * a try's terms are summed over its P lanes with __shfl_xor_sync.  The
//     counts are int32 and summed with wrap-around: every term count and
//     the total are counts of cells of a table with fewer than 2^31
//     entries, so any order of the sums gives the plain version's total
//     exactly;
//   * a try succeeds when its slab is in bounds (the bound tests in the
//     plain version's roundings: the Python scalars cast to the tensor's
//     dtype, one rounded product, one rounded sum; __f*_rn/__d*_rn keep
//     nvcc from contracting them) and the table finds it free.  A ballot
//     gives the round's K outcomes; the warp commits the tries up to and
//     including the first failure (the failed slot goes inactive, its box
//     stays) and discards the rest: the box and slot come by shuffle from
//     the lanes of the failed try (of the last try when none failed).
// Every step is integer lattice arithmetic except the two bound tests, so
// the boxes are the plain version's bit for bit.  A seed whose box is
// obstructed (seed_ok false) keeps its box.  Each success grows a box
// inside the world's finite lattice and each face fails once, so every
// warp ends.  Flat table indices are 32-bit: the entry points refuse a
// table of 2^31 entries or more (ops/corridor.py::_check raises first).
//
// What bounds it on an H100: latency.  A try reads 64 SAT entries (int32,
// through the read-only path; forest20's table is 1.1 MB and stays in
// L2), and an agent's tries are a chain: a success changes the box that
// the next slab is cut from.  Measured with the stamps below on an NVIDIA
// H100 80GB HBM3 at 700 W (1,980 MHz), forest20's cycle-4 call, busiest
// agent (89 tries): the first design (one thread an agent, each term's
// eight loads behind the branches of its empty and dropped tests) took
// 6,701 cycles a try, 6,424 of them in table reads, about eight serial L2
// round trips; this design at K = 8 takes 14 rounds of ~1,300 cycles
// (~650 in the reads, shuffles and ballot, ~650 in the rest: order, slab,
// bounds, addresses, commit), 204 cycles a try (PERF.md §6).
//
// Built with -DLSC_CORRIDOR_STAMPS, the stamped entry points record for
// each agent its tries, its rounds, and the clock64 cycles spent in table
// reads (from the loads' issue to the ballot's outcome) and in the rest;
// the package's own build has neither the stamps nor those entry points.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (lsc_planner_tpu_torch/ops/_build.py).
// Interface: plain C, pointers to contiguous device memory, the CUDA
// stream as an opaque pointer; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef LSC_CORRIDOR_K
#define LSC_CORRIDOR_K 8
#endif

namespace {

constexpr int kSpec = LSC_CORRIDOR_K;      // tries a round
static_assert(kSpec == 1 || kSpec == 4 || kSpec == 6 || kSpec == 8,
              "LSC_CORRIDOR_K: 1, 4, 6 or 8 tries a round");
constexpr int kWarps = 4;                  // agents a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

struct Sat {
  const int* __restrict__ sat;   // (S0, S1, S2) int32 prefix counts
  int dims[3];                   // S - 1: the grid's cells an axis
  int s1, s2;                    // row strides of the flat index
  int k0[3];                     // the grid's origin key
};

#ifdef LSC_CORRIDOR_STAMPS
// stamps (N, kStamps): tries, rounds, clock64 cycles in table reads, in
// the rest
constexpr int kStamps = 4;
// clock64() after `dep` is computed (and after every earlier memory op)
__device__ __forceinline__ long long stamp_after(unsigned dep) {
  asm volatile("" : : "r"(dep) : "memory");
  return clock64();
}
#endif

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// A round's order: the active slots in cyclic order after the last slot
// tried, p; a slot's rank is its place in it.  While every try succeeds
// the active slots do not change, so try j of the round is the slot of
// rank j % n after j / n whole turns of the n active slots.
struct Order {
  unsigned active;
  int n;
  unsigned inv;                  // 65536 / n + 1: j / n = (j inv) >> 16
  int rank[6];                   //   for every j <= 8 and n <= 6
};

__device__ __forceinline__ Order make_order(unsigned active, int p) {
  Order o;
  o.active = active;
  o.n = __popc(active);
  o.inv = o.n == 1 ? 65537u : o.n == 2 ? 32769u : o.n == 3 ? 21846u
        : o.n == 4 ? 16385u : o.n == 5 ? 13108u : 10923u;
  // bit d: slot (p + 1 + d) % 6
  const unsigned rot = ((active | (active << 6)) >> (p + 1)) & 0x3fu;
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    const int d = s - p - 1 + (s <= p ? 6 : 0);
    o.rank[s] = __popc(rot & ((1u << d) - 1u));
  }
  return o;
}

// Try j of the round (j <= 8): the whole turns before it, the slots tried
// once more before it (a mask), and its slot.
__device__ __forceinline__ void order_at(const Order& o, int j, int& turns,
                                         unsigned& first, int& slot) {
  turns = static_cast<int>((static_cast<unsigned>(j) * o.inv) >> 16);
  const int jm = j - turns * o.n;
  unsigned f[6];
  int sl[6];
#pragma unroll
  for (int s = 0; s < 6; ++s) {   // one active slot has rank jm
    const bool act = (o.active >> s) & 1u;
    f[s] = (act && o.rank[s] < jm) ? (1u << s) : 0u;
    sl[s] = (act && o.rank[s] == jm) ? s : 0;
  }
  first = (f[0] | f[1]) | (f[2] | f[3]) | (f[4] | f[5]);
  slot = (sl[0] + sl[1]) + (sl[2] + sl[3]) + (sl[4] + sl[5]);
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

// The world's bounds as the plain version forms them: the Python scalars
// cast to the tensor's dtype, then one rounded op.
template <typename T>
struct Bounds {
  float at_min_thr[3];
  T lo_thr[3], hi_thr[3];
  float res_f;
  T res_t;
};

// The slab of trying the face (axis ax, high or low) of box (lo, hi):
// its corners, its low face's at-minimum flags, and its in-bounds flag.
template <typename T>
__device__ __forceinline__ bool slab(const Bounds<T>& b, const int lo[3],
                                     const int hi[3], int ax, bool high,
                                     int s_lo[3], int s_hi[3],
                                     bool at_min[3]) {
  bool inb = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int one = (k == ax) ? 1 : 0;
    const int lo_n = high ? lo[k] : lo[k] - one;
    const int hi_n = high ? hi[k] + one : hi[k];
    // update slab: old face -> new face along ax, full elsewhere
    s_lo[k] = (k == ax) ? (high ? hi[k] : lo_n) : lo_n;
    s_hi[k] = (k == ax) ? (high ? hi_n : lo[k]) : hi_n;
    at_min[k] = __fmul_rn(static_cast<float>(s_lo[k]), b.res_f) <=
                b.at_min_thr[k];
    inb &= mul_rn<T>(static_cast<T>(s_lo[k]), b.res_t) > b.lo_thr[k];
    inb &= mul_rn<T>(static_cast<T>(s_hi[k]), b.res_t) < b.hi_thr[k];
  }
  return inb;
}

// Term m of the slab's obstruction count: its eight flat corner indices
// and its sign (0 when dropped at the world minimum or empty; its corners
// then still legal addresses).  OccupancySAT.box_obstructed: per axis the
// sampled cells are {lo-1} u [lo+1, hi] away from the world minimum and
// [lo, hi] at it; term m fixes the axes of its set bits to the excluded
// plane [lo, lo], and an axis at the minimum has no excluded plane, so
// its terms vanish.
__device__ __forceinline__ int term(const Sat& s, const int s_lo[3],
                                    const int s_hi[3], const bool at_min[3],
                                    int m, int idx[8]) {
  bool valid = true, empty = false;
  int lc[3], hc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int l = s_lo[k] - s.k0[k];
    const int h = s_hi[k] - s.k0[k];
    const bool bit = (m >> k) & 1;
    valid &= !(bit && at_min[k]);
    const int t_lo = bit ? l : l - 1 + (at_min[k] ? 1 : 0);
    const int t_hi = bit ? l : h;
    // OccupancySAT._box_count's clamps: cells [lc, hc) of the grid
    lc[k] = clampi(t_lo, s.dims[k]);
    hc[k] = clampi(t_hi + 1, s.dims[k]);
    empty |= hc[k] <= lc[k];
  }
  // corner c takes hc on axis a when bit a of c is set
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int x = (c & 1) ? hc[0] : lc[0];
    const int y = (c & 2) ? hc[1] : lc[1];
    const int z = (c & 4) ? hc[2] : lc[2];
    idx[c] = (x * s.s1 + y) * s.s2 + z;
  }
  return (valid && !empty) ? ((__popc(m) & 1) ? -1 : 1) : 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const int* __restrict__ lo0, const int* __restrict__ hi0,
              const long long* __restrict__ cand,
              const bool* __restrict__ seed_ok, Sat s,
              const float* __restrict__ wmin32, const T* __restrict__ wmin,
              const T* __restrict__ wmax, double res, double eps,
              double eps_f, int* __restrict__ lo_out,
              int* __restrict__ hi_out, int N,
              unsigned long long* __restrict__ stamps) {
  // a round's K tries on KP groups of P lanes, TPL terms a lane
  constexpr int K = kSpec;
  constexpr int KP = K <= 4 ? 4 : 8;
  constexpr int P = 32 / KP;
  constexpr int TPL = 8 / P;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= N) return;                     // the whole warp
  const int j = lane / P;                 // the lane's try
  const int m0 = (lane % P) * TPL;        // and its first term
  int lo[3], hi[3];
  Bounds<T> b;
  b.res_f = static_cast<float>(res);
  b.res_t = static_cast<T>(res);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = lo0[3 * i + k];
    hi[k] = hi0[3 * i + k];
    b.at_min_thr[k] = __fadd_rn(wmin32[k], static_cast<float>(eps_f));
    b.lo_thr[k] = add_rn<T>(wmin[k], -static_cast<T>(eps));
    b.hi_thr[k] = add_rn<T>(wmax[k], static_cast<T>(eps));
  }
  // the faces of the six slots: low[k] (high[k]) has bit q set when slot
  // q holds the low (high) face of axis k
  unsigned low[3] = {0u, 0u, 0u}, high[3] = {0u, 0u, 0u};
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const int face = static_cast<int>(cand[6 * i + q]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      low[k] |= (face % 3 == k && face < 3) ? (1u << q) : 0u;
      high[k] |= (face % 3 == k && face >= 3) ? (1u << q) : 0u;
    }
  }
  const unsigned on_y = low[1] | high[1], on_z = low[2] | high[2];
  const unsigned highs = high[0] | high[1] | high[2];
  unsigned active = seed_ok[i] ? 0x3fu : 0u;
  int p = 5;
#ifdef LSC_CORRIDOR_STAMPS
  unsigned long long n_try = 0, n_round = 0, c_read = 0, c_rest = 0;
#endif
  while (active) {
#ifdef LSC_CORRIDOR_STAMPS
    const long long t0 = clock64();
#endif
    const Order o = make_order(active, p);
    // the lane's try, cut from the box that the tries before it leave if
    // they all succeed, and that box grown by it
    int turns, slot;
    unsigned first;
    order_at(o, j, turns, first, slot);
    int t_lo[3], t_hi[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      t_lo[k] = lo[k] - (turns * __popc(active & low[k]) +
                         __popc(first & low[k]));
      t_hi[k] = hi[k] + (turns * __popc(active & high[k]) +
                         __popc(first & high[k]));
    }
    const int ax = ((on_y >> slot) & 1u) ? 1 : (((on_z >> slot) & 1u) ? 2
                                                                      : 0);
    const bool up = (highs >> slot) & 1u;
    int s_lo[3], s_hi[3];
    bool at_min[3];
    const bool inb = slab<T>(b, t_lo, t_hi, ax, up, s_lo, s_hi, at_min);
    int idx[TPL][8], sign[TPL];
#pragma unroll
    for (int t = 0; t < TPL; ++t)
      sign[t] = term(s, s_lo, s_hi, at_min, m0 + t, idx[t]);
#ifdef LSC_CORRIDOR_STAMPS
    const long long t1 = stamp_after(static_cast<unsigned>(idx[TPL - 1][7]));
#endif
    // every read of the round, then the sums
    int v[TPL][8];
#pragma unroll
    for (int t = 0; t < TPL; ++t) {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        v[t][q] = j < K ? __ldg(s.sat + idx[t][q]) : 0;
    }
    unsigned sum = 0;
#pragma unroll
    for (int t = 0; t < TPL; ++t) {
      // (-1)^(3 - popcount) a corner
      const unsigned u[8] = {
          static_cast<unsigned>(v[t][0]), static_cast<unsigned>(v[t][1]),
          static_cast<unsigned>(v[t][2]), static_cast<unsigned>(v[t][3]),
          static_cast<unsigned>(v[t][4]), static_cast<unsigned>(v[t][5]),
          static_cast<unsigned>(v[t][6]), static_cast<unsigned>(v[t][7])};
      const unsigned c = ((u[1] - u[0]) + (u[2] - u[3])) +
                         ((u[4] - u[5]) + (u[7] - u[6]));
      sum += c * static_cast<unsigned>(sign[t]);
    }
#pragma unroll
    for (int w = 1; w < P; w <<= 1) sum += __shfl_xor_sync(kFull, sum, w);
    const unsigned votes =
        __ballot_sync(kFull, inb && static_cast<int>(sum) <= 0);
    unsigned ok = 0;                      // bit j: try j succeeds
#pragma unroll
    for (int jj = 0; jj < K; ++jj) ok |= ((votes >> (jj * P)) & 1u) << jj;
#ifdef LSC_CORRIDOR_STAMPS
    const long long t2 = stamp_after(ok);
#endif
    // commit through the first failure f (K when every try succeeded):
    // the box before try f and its slot, which goes inactive, or the box
    // after try K - 1 and its slot
    const int f = __ffs(~ok) - 1;
    const int src = (f < K ? f : K - 1) * P;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const bool grown = f == K && k == ax;
      lo[k] = __shfl_sync(kFull, t_lo[k] - (grown && !up ? 1 : 0), src);
      hi[k] = __shfl_sync(kFull, t_hi[k] + (grown && up ? 1 : 0), src);
    }
    p = __shfl_sync(kFull, slot, src);
    if (f < K) active &= ~(1u << p);
#ifdef LSC_CORRIDOR_STAMPS
    const long long t3 = stamp_after(active);
    n_try += f < K ? f + 1 : K;
    n_round += 1;
    c_read += t2 - t1;
    c_rest += (t1 - t0) + (t3 - t2);
#endif
  }
  if (lane < 3) {
    lo_out[3 * i + lane] = lane == 0 ? lo[0] : (lane == 1 ? lo[1] : lo[2]);
    hi_out[3 * i + lane] = lane == 0 ? hi[0] : (lane == 1 ? hi[1] : hi[2]);
  }
#ifdef LSC_CORRIDOR_STAMPS
  if (lane == 0) {
    stamps[kStamps * i + 0] = n_try;
    stamps[kStamps * i + 1] = n_round;
    stamps[kStamps * i + 2] = c_read;
    stamps[kStamps * i + 3] = c_rest;
  }
#endif
}

constexpr long long kMaxEntries = 1ll << 31;

template <typename T>
int launch_expand(const void* lo0, const void* hi0, const void* cand,
                  const void* seed_ok, const void* sat, int S0, int S1,
                  int S2, long long k0x, long long k0y, long long k0z,
                  const void* wmin32, const void* wmin, const void* wmax,
                  double res, double eps, double eps_f, void* lo_out,
                  void* hi_out, int N, void* stamps, void* stream) {
  const long long k0[3] = {k0x, k0y, k0z};
  if (N < 0 || S0 < 1 || S1 < 1 || S2 < 1 ||
      static_cast<long long>(S0) * S1 * S2 >= kMaxEntries)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < 3; ++k) {
    if (k0[k] < -(1ll << 30) || k0[k] > (1ll << 30))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return static_cast<int>(cudaGetLastError());
  Sat s;
  s.sat = static_cast<const int*>(sat);
  s.dims[0] = S0 - 1;
  s.dims[1] = S1 - 1;
  s.dims[2] = S2 - 1;
  s.s1 = S1;
  s.s2 = S2;
  for (int k = 0; k < 3; ++k) s.k0[k] = static_cast<int>(k0[k]);
  const int blocks = (N + kWarps - 1) / kWarps;
  expand_kernel<T><<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lo0), static_cast<const int*>(hi0),
      static_cast<const long long*>(cand), static_cast<const bool*>(seed_ok),
      s, static_cast<const float*>(wmin32), static_cast<const T*>(wmin),
      static_cast<const T*>(wmax), res, eps, eps_f,
      static_cast<int*>(lo_out), static_cast<int*>(hi_out), N,
      static_cast<unsigned long long*>(stamps));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// lo0, hi0 (N, 3) int32 absolute lattice corners; cand (N, 6) int64 face
// slots; seed_ok (N,) bool; sat (S0, S1, S2) int32 with origin key k0,
// fewer than 2^31 entries; wmin32 (3,) f32; wmin, wmax (3,) in the working
// dtype; res, eps (the in-bounds epsilon), eps_f (the float32 at-minimum
// epsilon) -> lo_out, hi_out (N, 3) int32.
int lsc_expand_boxes_f32(const void* lo0, const void* hi0, const void* cand,
                         const void* seed_ok, const void* sat, int S0, int S1,
                         int S2, long long k0x, long long k0y, long long k0z,
                         const void* wmin32, const void* wmin,
                         const void* wmax, double res, double eps,
                         double eps_f, void* lo_out, void* hi_out, int N,
                         void* stream) {
  return launch_expand<float>(lo0, hi0, cand, seed_ok, sat, S0, S1, S2, k0x,
                              k0y, k0z, wmin32, wmin, wmax, res, eps, eps_f,
                              lo_out, hi_out, N, nullptr, stream);
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
                               lo_out, hi_out, N, nullptr, stream);
}

// The tries a round this build speculates (LSC_CORRIDOR_K).
int lsc_expand_boxes_k() { return kSpec; }

#ifdef LSC_CORRIDOR_STAMPS
// The same with each agent's clock stamps, stamps (N, kStamps) uint64 on
// the device: the measurement build's entry points.
int lsc_expand_boxes_stamped_f32(
    const void* lo0, const void* hi0, const void* cand, const void* seed_ok,
    const void* sat, int S0, int S1, int S2, long long k0x, long long k0y,
    long long k0z, const void* wmin32, const void* wmin, const void* wmax,
    double res, double eps, double eps_f, void* lo_out, void* hi_out, int N,
    void* stamps, void* stream) {
  return launch_expand<float>(lo0, hi0, cand, seed_ok, sat, S0, S1, S2, k0x,
                              k0y, k0z, wmin32, wmin, wmax, res, eps, eps_f,
                              lo_out, hi_out, N, stamps, stream);
}

int lsc_expand_boxes_stamped_f64(
    const void* lo0, const void* hi0, const void* cand, const void* seed_ok,
    const void* sat, int S0, int S1, int S2, long long k0x, long long k0y,
    long long k0z, const void* wmin32, const void* wmin, const void* wmax,
    double res, double eps, double eps_f, void* lo_out, void* hi_out, int N,
    void* stamps, void* stream) {
  return launch_expand<double>(lo0, hi0, cand, seed_ok, sat, S0, S1, S2, k0x,
                               k0y, k0z, wmin32, wmin, wmax, res, eps, eps_f,
                               lo_out, hi_out, N, stamps, stream);
}
#endif

}  // extern "C"
