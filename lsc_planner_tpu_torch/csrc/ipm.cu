// The whole interior-point solve of the factored LSC QP rows, in one launch.
//
// Replaces lsc_planner_tpu/ops/ipm_pallas.py::_ipm_kernel (wrapper
// ipm_lsc_fused): every Mehrotra predictor-corrector iteration of every QP
// of the batch runs inside this kernel, with the TPU kernel's arithmetic:
// the Gram P + A'DA formed from the factored rows (static +- row pairs
// through the unique rows U, plane rows scale * normal (x) F_seg), Jacobi
// scaling with a ridge and the scaled diagonal forced to 1 + 1e-6, a
// Cholesky whose pivots are floored at 1e-6, predictor, corrector and
// Gondzio correctors (kept only when they lengthen the steps by more than
// 0.05) on the same factor, tau = 0.995, the NaN guard, the per-QP latch,
// and the exit test on the new iterate.  The plain PyTorch transcription
// is lsc_planner_tpu_torch/ops/ipm.py::ipm_lsc_fused_plain.
//
// What bounds it on an H100: latency, not FLOPs or bytes.  One iteration
// is ~2.4e5 operations a QP at C = 32 (the Gram, the factor, the row
// products), and a QP's input is ~60 KB, read once.  The time is made of
// dependent steps: the 39 Cholesky columns, three 78-step triangular
// substitution chains, the passes over the rows and their reductions, for
// up to 40 iterations.
//
// What the design does about that:
// * One warp a QP, several QPs a block.  A QP synchronises with
//   __syncwarp and warp shuffles only: no block barrier after the one that
//   publishes the block's shared tables, so a QP that latches done leaves
//   its loop without stalling the QPs beside it.  Every reduction is a
//   butterfly of shuffles, so every lane holds the same bits and the exit
//   and keep decisions need no broadcast.
// * U, F_seg and the Gram's entry tables are loaded once a block.
// * The factor runs in registers (warp_chol.cuh: lane l owns rows l and
//   l + 32, each column broadcast by shuffle) and keeps the reciprocal of
//   each diagonal entry, so the three KKT solves of an iteration multiply
//   instead of divide; the substitutions read L from the QP's shared tile.
//   (Forming L^-1 instead would turn each solve into two matrix-vector
//   products but costs another nv^3/3 chain an iteration; with three
//   solves an iteration the chains it saves are shorter than it.)
// * Per row only what the passes cannot recompute cheaply: a plane row
//   keeps its slack, dual, primal residual, the complementarity right-hand
//   side of each of the two direction sets, and a copy of its scale (6
//   floats), its (c, m) block the 3 normal components; a static +- pair
//   keeps its two slacks, two duals, two primal residuals, Gram weight,
//   rmv weight, and per direction set two right-hand sides and its value
//   at dy (14 floats).  Steps ds and dl are recomputed from dy's basis
//   values wherever a pass needs them; the bounds are read from device
//   memory once an iteration, by the pass that forms the residuals.
// * Per-QP bytes (nf = 13, Ru = 69, M = 5, n + 1 = 6): 9.9 KB of vectors
//   and the 39 x 39 Gram / factor tile, plus the rows: 35.8 KB at C = 32,
//   60.1 KB at C = 64, 108.9 KB at C = 128; a block's tables take 16.2 KB.
//   The rows live in shared memory (as many QPs a block as fit: 4 at
//   C = 32, 1 at C = 128) unless that takes more waves of blocks over the
//   SMs for the batch than keeping them in a device-memory scratch of the
//   same layout (4 QPs a block, 55.6 KB); both layouts walk the rows in
//   the same order, row (c, j) by lane j.  On the H100 (700 W) at B = 1024,
//   C = 32 that picks device memory (8 QPs an SM, one wave: 3.7 ms against
//   4.2 ms with 4 QPs an SM in shared memory, two waves); at B = 128,
//   C = 128 shared memory (1.87 against 3.4 ms).
// * Registers: ~255 a thread with no spills (the factor's rows are 71 of
//   them), so 8 QPs resident an SM with the rows in device memory.
//   Capping them at 128 spilled and ran slower on the H100 (4.7 against
//   3.7 ms at B = 1024, C = 32): at 1024 QPs an SM holds ~8 anyway.
// * No runtime integer division in the passes: plane rows are walked as
//   (j = lane, c = 0..C-1), static rows with k decoded by comparisons, the
//   Gram's entries through tables built once a block; the kernel is
//   templated on (nf, M, n + 1) = (13, 5, 6), the main path's shape, with
//   a generic instantiation (template arguments 0) for every other shape.
// * The world's dimension D (the TPU kernel's static ndim) is a template
//   argument too: D = 3, and D = 2 for a 2-D world, whose QP drops the z
//   block (nv = 2 nf, D normal components, D (D + 1) / 2 Gram weights a
//   basis point).  Every size above is for D = 3; the D = 3 code is the
//   same arithmetic, in the same order, as before D was a parameter.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (lsc_planner_tpu_torch/ops/_build.py).
// Interface: plain C, pointers to contiguous float32 device memory, the
// CUDA stream as an opaque pointer; the entry point returns
// cudaGetLastError() (or the error of the shared-memory attribute call).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_chol.cuh"

namespace {

constexpr int kMaxNv = 64;          // two factor rows a lane
constexpr int kMaxQpb = 8;          // QPs (warps) a block
constexpr int kGlobalQpb = 4;       // QPs a block with rows in device memory
constexpr size_t kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// jnp.minimum / jnp.maximum: a NaN operand gives NaN
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = jmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = jmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float ratio(float v, float dv) {
  return dv < 0.f ? -v / dv : INFINITY;
}

struct Params {
  const float *Pb, *q, *y0, *U, *bs, *nsc, *scale, *bpl, *F, *sig;
  float *y_out, *lam_s, *lam_p, *gap;
  int* it_out;
  float* scratch;            // per-QP row slabs when rows_smem == 0
  size_t slab;               // floats a slab
  int rows_smem, qpb;
  int N, nf, Ru, C, M, n1, iters, correctors;
  float reg, s_min, tol_gap, tol_rp, tol_rd, tol_step;
};

__host__ __device__ __forceinline__ size_t r4(size_t n) {
  return (n + 3) & ~static_cast<size_t>(3);       // 16-byte aligned slices
}

// Block-wide tables, in this order: U, F_seg, and the Gram's entry lists
// (the lower triangle of H as i << 8 | j, the static blocks' lower
// triangles as k << 16 | f << 8 | g).  Sizes in floats; D the dimension.
__host__ __device__ __forceinline__ size_t shared_floats(int D, int nf,
                                                         int Ru, int MI) {
  const int nv = D * nf;
  return r4(D * Ru * nf) + r4(MI * nf) + r4(nv * (nv + 1) / 2) +
         r4(D * nf * (nf + 1) / 2);
}

// Per-QP vectors, always in shared memory, in this order: Pb, q, y, rd,
// dsc, tmp, xby (D MI), W (D (D + 1) / 2 MI), vk (D MI), H (nv^2), then dy
// and xbd of direction set 0, then of set 1.
__host__ __device__ __forceinline__ size_t vec_off(int D, int nf, int MI,
                                                   int f) {
  const size_t nv4 = r4(D * nf), mi3 = r4(D * MI);
  const size_t w4 = r4(D * (D + 1) / 2 * MI);
  const size_t head = r4(nf * nf) + 5 * nv4;          // Pb .. tmp
  const size_t body = head + mi3 + w4 + mi3 + r4(D * D * nf * nf);
  switch (f) {
    case 0: return 0;                                  // Pb
    case 1: return r4(nf * nf);                        // q, y, rd, dsc, tmp
    case 6: return head;                               // xby
    case 7: return head + mi3;                         // W
    case 8: return head + mi3 + w4;                    // vk
    case 9: return head + 2 * mi3 + w4;                // H
    case 10: return body;                              // dy0
    case 11: return body + nv4;                        // xbd0
    case 12: return body + nv4 + mi3;                  // dy1
    case 13: return body + 2 * nv4 + mi3;              // xbd1
    default: return body + 2 * (nv4 + mi3);            // total
  }
}
__host__ __device__ __forceinline__ size_t vec_floats(int D, int nf,
                                                      int MI) {
  return vec_off(D, nf, MI, 14);
}

// Per-QP row state, in shared memory or in a device-memory slab: six
// plane fields of R floats (slack, dual, primal residual, right-hand side
// of sets 0 and 1, and a copy of the row scale), the normals (D floats a
// (c, m)), then fourteen static fields of S = D Ru floats.
enum PlaneField { kSpl, kLpl, kRp, kRcPl, kScale = 5 };   // kRcPl + d
enum StaticField { kSsp, kSsm, kLsp, kLsm, kRpSp, kRpSm, kDpair, kWsu, kRcSp,
                   kRcSm = 10, kDsu = 12 };               // kRcSp + d, ...
__host__ __device__ __forceinline__ size_t row_floats(int D, int R, int CM,
                                                      int S) {
  return 6 * r4(R) + r4(D * CM) + 14 * r4(S);
}

// How the right-hand side of a KKT solve is formed, row by row.
enum Rule { kPredictor, kCorrector, kGondzio };

template <int D, int NF, int MT, int NT>
struct Qp {
  static constexpr int NVC = NF ? D * NF : kMaxNv;   // factor capacity
  static constexpr int NW = D * (D + 1) / 2;         // Gram weights a point

  int nf_, M_, n1_, Ru, S, C, R, lane, Rp, Sp;
  float* sb;                 // the block's tables
  float* vb;                 // this QP's vectors
  float* rb;                 // this QP's rows
  const float *nsc, *scale, *bpl, *bs0, *bs1;

  __device__ __forceinline__ int nf() const { return NF ? NF : nf_; }
  __device__ __forceinline__ int M() const { return MT ? MT : M_; }
  __device__ __forceinline__ int n1() const { return NT ? NT : n1_; }
  __device__ __forceinline__ int MI() const { return M() * n1(); }
  __device__ __forceinline__ int nv() const { return D * nf(); }
  __device__ __forceinline__ int kof(int t, int n) const {   // t / n, t < Dn
    return D == 3 ? (t >= n) + (t >= 2 * n) : (t >= n);
  }

  // the block's tables
  __device__ __forceinline__ const float* U() const { return sb; }
  __device__ __forceinline__ const float* F() const {
    return sb + r4(S * nf());
  }
  __device__ __forceinline__ const int* hent() const {
    return reinterpret_cast<const int*>(F() + r4(MI() * nf()));
  }
  __device__ __forceinline__ const int* sent() const {
    return hent() + r4(nv() * (nv() + 1) / 2);
  }
  // this QP's vectors
  __device__ __forceinline__ float* vec(int f) const {
    return vb + vec_off(D, nf(), MI(), f);
  }
  __device__ __forceinline__ float* Pb() const { return vec(0); }
  __device__ __forceinline__ float* q() const { return vec(1); }
  __device__ __forceinline__ float* y() const { return q() + r4(nv()); }
  __device__ __forceinline__ float* rd() const { return q() + 2 * r4(nv()); }
  __device__ __forceinline__ float* dsc() const {
    return q() + 3 * r4(nv());
  }
  __device__ __forceinline__ float* tmp() const {
    return q() + 4 * r4(nv());
  }
  __device__ __forceinline__ float* xby() const { return vec(6); }
  __device__ __forceinline__ float* W() const { return vec(7); }
  __device__ __forceinline__ float* vk() const { return vec(8); }
  __device__ __forceinline__ float* H() const { return vec(9); }
  __device__ __forceinline__ float* dy(int d) const {
    return vec(d ? 12 : 10);
  }
  __device__ __forceinline__ float* xbd(int d) const {
    return vec(d ? 13 : 11);
  }
  // this QP's rows
  __device__ __forceinline__ float* pf(int f) const { return rb + f * Rp; }
  __device__ __forceinline__ float* nrm() const { return rb + 6 * Rp; }
  __device__ __forceinline__ float* sf(int f) const {
    return rb + 6 * Rp + r4(D * C * M()) + f * Sp;
  }
  __device__ __forceinline__ float* s_pl() const { return pf(kSpl); }
  __device__ __forceinline__ float* l_pl() const { return pf(kLpl); }
  __device__ __forceinline__ float* rp_pl() const { return pf(kRp); }
  __device__ __forceinline__ float* scl() const { return pf(kScale); }
  __device__ __forceinline__ float* rc_pl(int d) const {
    return pf(kRcPl + d);
  }
  __device__ __forceinline__ float* s_sp() const { return sf(kSsp); }
  __device__ __forceinline__ float* s_sm() const { return sf(kSsm); }
  __device__ __forceinline__ float* l_sp() const { return sf(kLsp); }
  __device__ __forceinline__ float* l_sm() const { return sf(kLsm); }
  __device__ __forceinline__ float* rp_sp() const { return sf(kRpSp); }
  __device__ __forceinline__ float* rp_sm() const { return sf(kRpSm); }
  __device__ __forceinline__ float* dpair() const { return sf(kDpair); }
  __device__ __forceinline__ float* wsu() const { return sf(kWsu); }
  __device__ __forceinline__ float* rc_sp(int d) const {
    return sf(kRcSp + d);
  }
  __device__ __forceinline__ float* rc_sm(int d) const {
    return sf(kRcSm + d);
  }
  __device__ __forceinline__ float* dsu(int d) const { return sf(kDsu + d); }

  // Plane rows (c, m, i), c-major: lane j walks rows c * MI + j.
  template <class Fn>
  __device__ __forceinline__ void plane_rows(Fn fn) const {
    const int MIv = MI(), n1v = n1(), Mv = M();
    for (int j = lane; j < MIv; j += 32) {
      const int m = j / n1v;
#pragma unroll 4
      for (int c = 0; c < C; ++c) fn(c * MIv + j, c * Mv + m, j);
    }
  }
  // Static rows r = k * Ru + u.
  template <class Fn>
  __device__ __forceinline__ void static_rows(Fn fn) const {
    for (int r = lane; r < S; r += 32) fn(r, kof(r, Ru));
  }

  // scale * normal . x[:, j] for plane row r of normal block cm
  __device__ __forceinline__ float pval(const float* x, int r, int cm,
                                        int j) const {
    const int MIv = MI();
    const float sc = scl()[r];
    const float* n = nrm() + D * cm;
    float val = (n[0] * sc) * x[j];
#pragma unroll
    for (int k = 1; k < D; ++k) val = val + (n[k] * sc) * x[k * MIv + j];
    return val;
  }
  // U row r . vec[k, :]
  __device__ __forceinline__ float urow(const float* vec, int r,
                                        int k) const {
    const int nfv = nf();
    float acc = 0.f;
    for (int f = 0; f < nfv; ++f) acc += U()[r * nfv + f] * vec[k * nfv + f];
    return acc;
  }

  // xb[k, j] = F_seg[j, :] . vec[k, :]
  __device__ void basis(const float* vec, float* xb) const {
    const int nfv = nf(), MIv = MI();
    for (int k = 0; k < D; ++k)
      for (int j = lane; j < MIv; j += 32) {
        float acc = 0.f;
        for (int f = 0; f < nfv; ++f)
          acc += F()[j * nfv + f] * vec[k * nfv + f];
        xb[k * MIv + j] = acc;
      }
    __syncwarp();
  }

  // out = A^T w: the static weights in wsu(), the plane weight of each row
  // from wpl(r, cm, j) (called once a row).
  template <class Wpl>
  __device__ void rmv(Wpl wpl, float* out) const {
    const int nfv = nf(), MIv = MI(), nvv = nv();
    const int n1v = n1(), Mv = M();
    for (int j = lane; j < MIv; j += 32) {
      const int m = j / n1v;
      float a[D];
#pragma unroll
      for (int k = 0; k < D; ++k) a[k] = 0.f;
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
        const int r = c * MIv + j, cm = c * Mv + m;
        const float wr = wpl(r, cm, j);
        const float sc = scl()[r];
        const float* n = nrm() + D * cm;
#pragma unroll
        for (int k = 0; k < D; ++k) a[k] += (n[k] * sc) * wr;
      }
#pragma unroll
      for (int k = 0; k < D; ++k) vk()[k * MIv + j] = a[k];
    }
    __syncwarp();
    for (int t = lane; t < nvv; t += 32) {
      const int k = kof(t, nfv), f = t - k * nfv;
      float a = 0.f;
#pragma unroll 4
      for (int u = 0; u < Ru; ++u)
        a += U()[(k * Ru + u) * nfv + f] * wsu()[k * Ru + u];
      float b = 0.f;
      for (int j = 0; j < MIv; ++j)
        b += F()[j * nfv + f] * vk()[k * MIv + j];
      out[t] = a + b;
    }
    __syncwarp();
  }

  // (P y)[k, g] = sum_f Pb[f, g] y[k, f]
  __device__ __forceinline__ float py(int t) const {
    const int nfv = nf(), k = kof(t, nfv), g = t - k * nfv;
    float acc = 0.f;
    for (int f = 0; f < nfv; ++f)
      acc += Pb()[f * nfv + g] * y()[k * nfv + f];
    return acc;
  }

  // H = P + A^T D A (D = lam / s), Jacobi-scaled with the ridge, unit
  // diagonal forced to 1 + 1e-6, factored with the 1e-6 pivot floor; L
  // goes to H(), the scaling to dsc(), the diagonal's reciprocals to
  // rinv0 / rinv1.
  __device__ void gram_factor(float reg, float& rinv0, float& rinv1) const {
    const int nfv = nf(), nvv = nv(), MIv = MI();
    static_rows([&](int r, int) {
      dpair()[r] = l_sp()[r] / s_sp()[r] + l_sm()[r] / s_sm()[r];
    });
    {
      const int n1v = n1(), Mv = M();
      for (int j = lane; j < MIv; j += 32) {
        const int m = j / n1v;
        float acc[NW];
#pragma unroll
        for (int p = 0; p < NW; ++p) acc[p] = 0.f;
#pragma unroll 4
        for (int c = 0; c < C; ++c) {
          const int r = c * MIv + j, cm = c * Mv + m;
          const float d = l_pl()[r] / s_pl()[r];
          const float sc = scl()[r];
          const float* n = nrm() + D * cm;
          float ns[D];
#pragma unroll
          for (int k = 0; k < D; ++k) ns[k] = n[k] * sc;
          // the pairs (l, k), l <= k, row by row: 00 01 02 11 12 22
          int p = 0;
#pragma unroll
          for (int l = 0; l < D; ++l)
#pragma unroll
            for (int k = l; k < D; ++k) acc[p++] += ns[l] * ns[k] * d;
        }
#pragma unroll
        for (int p = 0; p < NW; ++p) W()[p * MIv + j] = acc[p];
      }
    }
    __syncwarp();
    // the static rows' Gram on the diagonal blocks' lower triangles
    const int ns = D * nfv * (nfv + 1) / 2;
    for (int e = lane; e < ns; e += 32) {
      const int code = sent()[e];
      const int k = code >> 16, f = (code >> 8) & 255, g = code & 255;
      float hst = 0.f;
#pragma unroll 4
      for (int u = 0; u < Ru; ++u) {
        const int ru = k * Ru + u;
        hst += U()[ru * nfv + f] * U()[ru * nfv + g] * dpair()[ru];
      }
      H()[(k * nfv + f) * nvv + k * nfv + g] = hst;
    }
    __syncwarp();
    // plane rows on the whole lower triangle, plus P on the diagonal blocks
    const int nh = nvv * (nvv + 1) / 2;
    for (int e = lane; e < nh; e += 32) {
      const int code = hent()[e];
      const int i = code >> 8, jj = code & 255;
      const int k = kof(i, nfv), f = i - k * nfv;
      const int l = kof(jj, nfv), g = jj - l * nfv;
      // W block of the dimension pair (l, k), l <= k: 0 1 2 / 3 4 / 5
      const float* Wp = W() + (D * l - ((l * (l - 1)) >> 1) + k - l) * MIv;
      float acc = 0.f;
      for (int j = 0; j < MIv; ++j)
        acc += F()[j * nfv + f] * F()[j * nfv + g] * Wp[j];
      float* h = H() + i * nvv + jj;
      *h = k == l ? (acc + *h) + Pb()[f * nfv + g] : acc;
    }
    __syncwarp();
    float dsum = 0.f;
    for (int i = lane; i < nvv; i += 32) dsum += H()[i * nvv + i];
    dsum = warp_sum(dsum);
    const float ridge = reg * jmax(dsum / static_cast<float>(nvv), 1.f);
    for (int i = lane; i < nvv; i += 32)
      dsc()[i] = 1.f / sqrtf(H()[i * nvv + i] + ridge);
    __syncwarp();
    warp_chol::Rows<float, NVC> Rw;
    const float* Hm = H();
    const float* sc = dsc();
    warp_chol::load_rows(Rw, nvv, [&](int i, int jj) {
      return jj == i ? 1.f + 1e-6f : Hm[i * nvv + jj] * sc[i] * sc[jj];
    });
    warp_chol::factor(Rw, nvv, 1e-6f, rinv0, rinv1, H());
  }

  // plane row r's primal residual and the step of direction set d
  __device__ __forceinline__ void plane_step(int d, int r, int cm, int j,
                                             float& ds, float& dl) const {
    const float s = s_pl()[r];
    ds = pval(xbd(d), r, cm, j) + rp_pl()[r];
    dl = -(rc_pl(d)[r] + l_pl()[r] * ds) / s;
  }
  __device__ __forceinline__ void static_step(int d, int r, float& ds_p,
                                              float& ds_m, float& dl_p,
                                              float& dl_m) const {
    const float du = dsu(d)[r];
    ds_p = du + rp_sp()[r];
    ds_m = -du + rp_sm()[r];
    dl_p = -(rc_sp(d)[r] + l_sp()[r] * ds_p) / s_sp()[r];
    dl_m = -(rc_sm(d)[r] + l_sm()[r] * ds_m) / s_sm()[r];
  }

  // The right-hand side of a row under `rule` (src: the set it builds on).
  struct RcArgs {
    Rule rule;
    int src;
    float smu, a_p, a_d, lo, hi;
  };
  __device__ __forceinline__ float rc_of(const RcArgs& a, float s, float l,
                                         float rc_src, float ds,
                                         float dl) const {
    if (a.rule == kPredictor) return s * l;
    if (a.rule == kCorrector) return rc_src + ds * dl - a.smu;
    const float prod = (s + a.a_p * ds) * (l + a.a_d * dl);
    return rc_src + (jmin(jmax(prod, a.lo), a.hi) - prod);
  }

  // Newton direction into set d for the right-hand sides `a` forms (and
  // stores in set d): dy, its basis values and static row values.
  // Returns whether dy is not finite (the same in every lane).
  __device__ bool kkt(int d, const RcArgs& a, float rinv0,
                      float rinv1) const {
    const bool pred = a.rule == kPredictor;
    static_rows([&](int r, int) {
      float dsp = 0.f, dsm = 0.f, dlp = 0.f, dlm = 0.f;
      if (!pred) static_step(a.src, r, dsp, dsm, dlp, dlm);
      const float rcp = rc_of(a, s_sp()[r], l_sp()[r],
                              pred ? 0.f : rc_sp(a.src)[r], dsp, dlp);
      const float rcm = rc_of(a, s_sm()[r], l_sm()[r],
                              pred ? 0.f : rc_sm(a.src)[r], dsm, dlm);
      rc_sp(d)[r] = rcp;
      rc_sm(d)[r] = rcm;
      wsu()[r] = (rcp + l_sp()[r] * rp_sp()[r]) / s_sp()[r] -
                 (rcm + l_sm()[r] * rp_sm()[r]) / s_sm()[r];
    });
    rmv([&](int r, int cm, int j) {
      const float s = s_pl()[r], l = l_pl()[r];
      float ds = 0.f, dl = 0.f;
      if (!pred) plane_step(a.src, r, cm, j, ds, dl);
      const float rc = rc_of(a, s, l, pred ? 0.f : rc_pl(a.src)[r], ds, dl);
      rc_pl(d)[r] = rc;
      return (rc + l * rp_pl()[r]) / s;
    }, tmp());
    const int nvv = nv();
    const int r0 = lane, r1 = lane + 32;
    float z0 = r0 < nvv ? dsc()[r0] * (-rd()[r0] - tmp()[r0]) : 0.f;
    float z1 = r1 < nvv ? dsc()[r1] * (-rd()[r1] - tmp()[r1]) : 0.f;
    warp_chol::solve(H(), nvv, rinv0, rinv1, z0, z1);
    bool bad = false;
    if (r0 < nvv) {
      const float x = dsc()[r0] * z0;
      dy(d)[r0] = x;
      bad = !isfinite(x);
    }
    if (r1 < nvv) {
      const float x = dsc()[r1] * z1;
      dy(d)[r1] = x;
      bad = bad || !isfinite(x);
    }
    bad = __any_sync(kFull, bad);
    __syncwarp();
    basis(dy(d), xbd(d));
    static_rows([&](int r, int k) { dsu(d)[r] = urow(dy(d), r, k); });
    __syncwarp();
    return bad;
  }

  // (alpha_p, alpha_d): largest step in (0, 1] keeping slacks / duals above
  // (1 - 0.995) of their value
  __device__ float2 step_lens(int d) const {
    float mp = INFINITY, md = INFINITY;
    static_rows([&](int r, int) {
      float dsp, dsm, dlp, dlm;
      static_step(d, r, dsp, dsm, dlp, dlm);
      mp = jmin(mp, jmin(ratio(s_sp()[r], dsp), ratio(s_sm()[r], dsm)));
      md = jmin(md, jmin(ratio(l_sp()[r], dlp), ratio(l_sm()[r], dlm)));
    });
    plane_rows([&](int r, int cm, int j) {
      float ds, dl;
      plane_step(d, r, cm, j, ds, dl);
      mp = jmin(mp, ratio(s_pl()[r], ds));
      md = jmin(md, ratio(l_pl()[r], dl));
    });
    mp = warp_min(mp);
    md = warp_min(md);
    return make_float2(jmin(1.f, 0.995f * mp), jmin(1.f, 0.995f * md));
  }

  // sum over all rows of (s + a_p ds)(l + a_d dl) for direction set d
  __device__ float complementarity(int d, float a_p, float a_d) const {
    float acc = 0.f;
    static_rows([&](int r, int) {
      float dsp, dsm, dlp, dlm;
      static_step(d, r, dsp, dsm, dlp, dlm);
      acc += (s_sp()[r] + a_p * dsp) * (l_sp()[r] + a_d * dlp);
      acc += (s_sm()[r] + a_p * dsm) * (l_sm()[r] + a_d * dlm);
    });
    plane_rows([&](int r, int cm, int j) {
      float ds, dl;
      plane_step(d, r, cm, j, ds, dl);
      acc += (s_pl()[r] + a_p * ds) * (l_pl()[r] + a_d * dl);
    });
    return warp_sum(acc);
  }

  // sum over all rows of s l
  __device__ float gap_sum() const {
    float acc = 0.f;
    static_rows([&](int r, int) {
      acc += s_sp()[r] * l_sp()[r] + s_sm()[r] * l_sm()[r];
    });
    plane_rows([&](int r, int, int) { acc += s_pl()[r] * l_pl()[r]; });
    return warp_sum(acc);
  }

  // s += a_p ds, l += a_d dl along set d, floored at 1e-12
  __device__ void take_step(int d, float a_p, float a_d) const {
    static_rows([&](int r, int) {
      float dsp, dsm, dlp, dlm;
      static_step(d, r, dsp, dsm, dlp, dlm);
      s_sp()[r] = jmax(s_sp()[r] + a_p * dsp, 1e-12f);
      s_sm()[r] = jmax(s_sm()[r] + a_p * dsm, 1e-12f);
      l_sp()[r] = jmax(l_sp()[r] + a_d * dlp, 1e-12f);
      l_sm()[r] = jmax(l_sm()[r] + a_d * dlm, 1e-12f);
    });
    plane_rows([&](int r, int cm, int j) {
      float ds, dl;
      plane_step(d, r, cm, j, ds, dl);
      s_pl()[r] = jmax(s_pl()[r] + a_p * ds, 1e-12f);
      l_pl()[r] = jmax(l_pl()[r] + a_d * dl, 1e-12f);
    });
    __syncwarp();
  }

  // The rows' primal residuals at y, the dual residual
  // r_d = P y + q - A^T lam,
  // and the exit test's sums: returns (sum s l, max |r_p|, max |r_d|).
  __device__ float3 rows_and_residual() const {
    basis(y(), xby());
    float acc = 0.f, rpm = -INFINITY;
    static_rows([&](int r, int k) {
      const float u = urow(y(), r, k);
      const float rpp = u - s_sp()[r] - __ldg(bs0 + r);
      const float rpn = -u - s_sm()[r] - __ldg(bs1 + r);
      rp_sp()[r] = rpp;
      rp_sm()[r] = rpn;
      wsu()[r] = l_sp()[r] - l_sm()[r];
      acc += s_sp()[r] * l_sp()[r] + s_sm()[r] * l_sm()[r];
      rpm = jmax(rpm, fabsf(rpp));
      rpm = jmax(rpm, fabsf(rpn));
    });
    rmv([&](int r, int cm, int j) {
      const float pv = pval(xby(), r, cm, j);
      const float rp = pv - s_pl()[r] - __ldg(bpl + r);
      rp_pl()[r] = rp;
      acc += s_pl()[r] * l_pl()[r];
      rpm = jmax(rpm, fabsf(rp));
      return l_pl()[r];
    }, tmp());
    float rdm = -INFINITY;
    for (int t = lane; t < nv(); t += 32) {
      const float res = (py(t) + q()[t]) - tmp()[t];
      rd()[t] = res;
      rdm = jmax(rdm, fabsf(res));
    }
    __syncwarp();
    return make_float3(warp_sum(acc), warp_max(rpm), warp_max(rdm));
  }

  __device__ void run(const Params& p, size_t b) {
    const int nfv = nf(), nvv = nv();
    for (int e = lane; e < nfv * nfv; e += 32)
      Pb()[e] = p.Pb[b * nfv * nfv + e];
    for (int e = lane; e < nvv; e += 32) {
      q()[e] = p.q[b * nvv + e];
      y()[e] = p.y0[b * nvv + e];
    }
    // the row scales and normals, into this QP's rows
    plane_rows([&](int r, int, int) { scl()[r] = __ldg(scale + r); });
    for (int e = lane; e < D * C * M(); e += 32) nrm()[e] = __ldg(nsc + e);
    __syncwarp();
    const float sig = p.sig[b];

    // initial point: slacks from the start y, unit duals
    basis(y(), xby());
    static_rows([&](int r, int k) {
      const float u = urow(y(), r, k);
      s_sp()[r] = jmax(u - __ldg(bs0 + r), p.s_min);
      s_sm()[r] = jmax(-u - __ldg(bs1 + r), p.s_min);
      l_sp()[r] = 1.f;
      l_sm()[r] = 1.f;
    });
    plane_rows([&](int r, int cm, int j) {
      s_pl()[r] = jmax(pval(xby(), r, cm, j) - __ldg(bpl + r), p.s_min);
      l_pl()[r] = 1.f;
    });
    __syncwarp();
    const float nr = static_cast<float>(2 * S + R);
    float mu = rows_and_residual().x / nr;

    int it_used = p.iters;
    for (int it = 0; it < p.iters; ++it) {
      float rinv0, rinv1;
      gram_factor(p.reg, rinv0, rinv1);

      // predictor (affine scaling), direction set 0
      RcArgs rc{kPredictor, 0, 0.f, 0.f, 0.f, 0.f, 0.f};
      bool bad0 = kkt(0, rc, rinv0, rinv1);
      float2 a = step_lens(0);
      const float mu_aff = complementarity(0, a.x, a.y) / nr;
      float sigma = mu_aff / jmax(mu, 1e-30f);
      sigma = sigma * sigma * sigma;
      const float smu = sigma * mu;

      // corrector, direction set 1
      rc = RcArgs{kCorrector, 0, smu, 0.f, 0.f, 0.f, 0.f};
      bool bad1 = kkt(1, rc, rinv0, rinv1);
      a = step_lens(1);
      float a_p = a.x, a_d = a.y;

      // Gondzio correctors: candidate in the other set, kept by a swap.
      // The TPU kernel mixes candidate and current with 0/1 weights, so a
      // non-finite step in either turns the mixed step into NaN and the NaN
      // guard below rejects the iteration: `poison` carries that.
      int cur = 1;
      bool poison = false;
      for (int g = 0; g < p.correctors; ++g) {
        rc = RcArgs{kGondzio, cur, smu, a_p, a_d, 0.1f * smu, 10.f * smu};
        const bool nb = kkt(1 - cur, rc, rinv0, rinv1);
        if (cur == 1) bad0 = nb; else bad1 = nb;
        const float2 a2 = step_lens(1 - cur);
        poison = poison || bad0 || bad1 || !isfinite(a2.x) || !isfinite(a2.y);
        if (a2.x + a2.y > a_p + a_d + 0.05f) {
          cur = 1 - cur;
          a_p = a2.x;
          a_d = a2.y;
        }
      }
      const float* dir = dy(cur);

      // step and NaN guard
      float m = -INFINITY;
      bool fin = true;
      for (int i = lane; i < nvv; i += 32) {
        m = jmax(m, fabsf(dir[i]));
        fin = fin && isfinite(y()[i] + a_p * dir[i]);
      }
      m = warp_max(m);
      fin = __all_sync(kFull, fin);
      const bool ok = fin && isfinite(a_p) && isfinite(a_d) &&
                      isfinite(mu_aff) && isfinite(sigma) && !poison;
      if (!ok) continue;                  // rejected: iterate unchanged
      const float step_disp = a_p * m;
      for (int i = lane; i < nvv; i += 32) y()[i] = y()[i] + a_p * dir[i];
      take_step(cur, a_p, a_d);

      // exit test on the new iterate; its row values and r_d are the next
      // iteration's
      const float3 ex = rows_and_residual();
      mu = ex.x / nr;
      if (mu < p.tol_gap * sig && ex.y < p.tol_rp &&
          (ex.z < p.tol_rd || step_disp < p.tol_step)) {
        it_used = it + 1;
        break;
      }
    }

    // the solution
    for (int t = lane; t < nvv; t += 32) p.y_out[b * nvv + t] = y()[t];
    static_rows([&](int r, int) {
      p.lam_s[b * 2 * S + r] = l_sp()[r];
      p.lam_s[b * 2 * S + S + r] = l_sm()[r];
    });
    plane_rows([&](int r, int, int) { p.lam_p[b * R + r] = l_pl()[r]; });
    const float gap = gap_sum() / nr;
    if (lane == 0) {
      p.gap[b] = gap;
      p.it_out[b] = it_used;
    }
  }
};

template <int D, int NF, int MT, int NT>
__global__ void __launch_bounds__(kMaxQpb * 32) ipm_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Qp<D, NF, MT, NT> Q;
  Q.nf_ = p.nf;
  Q.M_ = p.M;
  Q.n1_ = p.n1;
  const int nf = Q.nf(), MI = Q.MI(), nv = Q.nv();
  Q.Ru = p.Ru;
  Q.S = D * p.Ru;
  Q.C = p.C;
  Q.R = p.C * MI;
  Q.lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // ---- the block's tables: the only block barrier ----
  Q.sb = reinterpret_cast<float*>(smem_raw);
  float* U = Q.sb;
  float* F = U + r4(Q.S * nf);
  int* hent = reinterpret_cast<int*>(F + r4(MI * nf));
  int* sent = hent + r4(nv * (nv + 1) / 2);
  for (int e = threadIdx.x; e < Q.S * nf; e += blockDim.x) U[e] = p.U[e];
  for (int e = threadIdx.x; e < MI * nf; e += blockDim.x) F[e] = p.F[e];
  for (int i = threadIdx.x; i < nv; i += blockDim.x)
    for (int j = 0; j <= i; ++j) hent[i * (i + 1) / 2 + j] = i << 8 | j;
  for (int t = threadIdx.x; t < D * nf; t += blockDim.x) {
    const int k = t / nf, f = t - k * nf;
    for (int g = 0; g <= f; ++g)
      sent[k * (nf * (nf + 1) / 2) + f * (f + 1) / 2 + g] =
          k << 16 | f << 8 | g;
  }
  __syncthreads();

  const size_t b = static_cast<size_t>(blockIdx.x) * p.qpb + warp;
  if (b >= static_cast<size_t>(p.N)) return;
  // this warp's slice of the block's shared memory: vectors, then (with
  // rows in shared memory) rows
  const size_t vec = vec_floats(D, nf, MI);
  const size_t rows = row_floats(D, Q.R, p.C * Q.M(), Q.S);
  const size_t per_qp = vec + (p.rows_smem ? rows : 0);
  Q.vb = Q.sb + shared_floats(D, nf, p.Ru, MI) + warp * per_qp;
  Q.rb = p.rows_smem ? Q.vb + vec : p.scratch + b * p.slab;
  Q.Rp = static_cast<int>(r4(Q.R));
  Q.Sp = static_cast<int>(r4(Q.S));
  Q.nsc = p.nsc + b * p.C * p.M * D;
  Q.scale = p.scale + b * Q.R;
  Q.bpl = p.bpl + b * Q.R;
  Q.bs0 = p.bs + b * 2 * Q.S;
  Q.bs1 = Q.bs0 + Q.S;
  Q.run(p, b);
}

// How a launch lays its QPs out.
struct Plan {
  int rows_smem;             // 1: rows in shared memory, 0: device memory
  int qpb;                   // QPs (warps) a block, 0: no such layout
  size_t smem;               // bytes a block
  size_t slab;               // floats of device memory a QP (rows_smem 0)
  int resident;              // QPs resident an SM
};

// The layout of qpb QPs a block with the rows in shared memory
// (smem_rows) or in device memory; qpb 0 takes as many as fit, at most
// kMaxQpb with rows in shared memory and kGlobalQpb in device memory.
Plan layout(int D, int nf, int Ru, int C, int M, int n1, bool smem_rows,
            int qpb = 0) {
  const int MI = M * n1, R = C * MI, S = D * Ru;
  const size_t shared = shared_floats(D, nf, Ru, MI) * sizeof(float);
  const size_t rows = row_floats(D, R, C * M, S);
  const size_t per_qp =
      (vec_floats(D, nf, MI) + (smem_rows ? rows : 0)) * sizeof(float);
  if (qpb == 0) {
    const int fit =
        kMaxSmem > shared ? static_cast<int>((kMaxSmem - shared) / per_qp)
                          : 0;
    const int cap = smem_rows ? kMaxQpb : kGlobalQpb;
    qpb = fit > cap ? cap : fit;
  }
  return Plan{smem_rows ? 1 : 0, qpb, shared + qpb * per_qp,
              smem_rows ? 0 : rows, 0};
}

bool specialised(int nf, int M, int n1) {
  return nf == 13 && M == 5 && n1 == 6;
}

// The kernel may take kMaxSmem of dynamic shared memory on the current
// device from the plan's resident() on (lsc_ipm_fused_plan).
template <int D, int NF, int MT, int NT>
int launch(Params& p, const Plan& pl, cudaStream_t stream) {
  const int blocks = (p.N + pl.qpb - 1) / pl.qpb;
  ipm_kernel<D, NF, MT, NT><<<blocks, pl.qpb * 32, pl.smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// QPs of layout pl resident an SM (the CUDA occupancy calculator), or a
// negative CUDA error.  Lets the kernel take kMaxSmem of dynamic shared
// memory on the current device, as every launch needs.
template <int D, int NF, int MT, int NT>
int resident(const Plan& pl) {
  if (pl.qpb < 1) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      ipm_kernel<D, NF, MT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, ipm_kernel<D, NF, MT, NT>, pl.qpb * 32, pl.smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return blocks * pl.qpb;
}

// rows_mode 1 / 2 force the rows into shared / device memory; 0 keeps
// them in shared memory unless that takes more waves of blocks over the
// card's SMs for N QPs than device memory does.  qpb 0: no layout;
// resident < 0: a CUDA error.
template <int D, int NF, int MT, int NT>
Plan make_plan(int N, int nf, int Ru, int C, int M, int n1, int rows_mode) {
  Plan s = layout(D, nf, Ru, C, M, n1, true);
  Plan g = layout(D, nf, Ru, C, M, n1, false);
  s.resident = resident<D, NF, MT, NT>(s);
  g.resident = resident<D, NF, MT, NT>(g);
  if (s.resident < 0) return s;
  if (g.resident < 0) return g;
  if (rows_mode == 1) return s;
  if (rows_mode == 2 || s.resident < 1) return g;
  if (g.resident < 1) return s;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long ws = (N + static_cast<long long>(sms) * s.resident - 1) /
                       (static_cast<long long>(sms) * s.resident);
  const long long wg = (N + static_cast<long long>(sms) * g.resident - 1) /
                       (static_cast<long long>(sms) * g.resident);
  return ws <= wg ? s : g;
}

template <int D>
Plan plan_d(int N, int nf, int Ru, int C, int M, int n1, int rows_mode) {
  return specialised(nf, M, n1)
             ? make_plan<D, 13, 5, 6>(N, nf, Ru, C, M, n1, rows_mode)
             : make_plan<D, 0, 0, 0>(N, nf, Ru, C, M, n1, rows_mode);
}

Plan plan_for(int D, int N, int nf, int Ru, int C, int M, int n1,
              int rows_mode) {
  return D == 2 ? plan_d<2>(N, nf, Ru, C, M, n1, rows_mode)
                : plan_d<3>(N, nf, Ru, C, M, n1, rows_mode);
}

template <int D>
int launch_d(Params& p, const Plan& pl, cudaStream_t stream) {
  return specialised(p.nf, p.M, p.n1) ? launch<D, 13, 5, 6>(p, pl, stream)
                                      : launch<D, 0, 0, 0>(p, pl, stream);
}

bool valid(int D, int N, int nf, int Ru, int C, int M, int n1) {
  return (D == 2 || D == 3) && N >= 0 && nf >= 1 && D * nf <= kMaxNv &&
         Ru >= 1 && C >= 1 && M >= 1 && n1 >= 1;
}

}  // namespace

extern "C" {

// The layout a launch of N QPs of dimension D (2 or 3) at these shapes
// uses: out[0] rows in
// shared memory (1) or device memory (0), out[1] QPs a block, out[2]
// shared-memory bytes a block, out[3] floats of device-memory scratch a
// QP (0 with rows in shared memory), out[4] QPs resident an SM (blocks an
// SM x QPs a block, from the CUDA occupancy calculator), out[5] 1 for the
// kernel specialised to (nf, M, n + 1) = (13, 5, 6).  Returns 0, or a
// CUDA error.  Call it on a device before the first launch there, and
// pass out[0] and out[1] to lsc_ipm_fused_f32.
int lsc_ipm_fused_plan(int D, int N, int nf, int Ru, int C, int M, int n1,
                       int rows_mode, long long* out) {
  if (!valid(D, N, nf, Ru, C, M, n1) || rows_mode < 0 || rows_mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan_for(D, N, nf, Ru, C, M, n1, rows_mode);
  if (pl.resident < 0) return -pl.resident;
  if (pl.qpb < 1) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = pl.rows_smem;
  out[1] = pl.qpb;
  out[2] = static_cast<long long>(pl.smem);
  out[3] = static_cast<long long>(pl.slab);
  out[4] = pl.resident;
  out[5] = specialised(nf, M, n1) ? 1 : 0;
  return 0;
}

int lsc_ipm_fused_f32(const void* Pb, const void* q, const void* y0,
                      const void* U, const void* b_pairs, const void* nsc,
                      const void* scale, const void* b_pl, const void* F_seg,
                      const void* sigma, void* y, void* lam_s, void* lam_p,
                      void* gap, void* iters_used, void* scratch,
                      long long scratch_floats, int rows_smem, int qpb, int D,
                      int N, int nf, int Ru, int C, int M, int n1, int iters,
                      int correctors, float reg, float s_min, float tol_gap,
                      float tol_rp, float tol_rd, float tol_step,
                      void* stream) {
  if (!valid(D, N, nf, Ru, C, M, n1) || iters < 0 || correctors < 0 ||
      rows_smem < 0 || rows_smem > 1 || qpb < 1 ||
      qpb > (rows_smem ? kMaxQpb : kGlobalQpb))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  const Plan pl = layout(D, nf, Ru, C, M, n1, rows_smem == 1, qpb);
  if (pl.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (!pl.rows_smem &&
      (scratch == nullptr ||
       scratch_floats < static_cast<long long>(pl.slab) * N))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.Pb = static_cast<const float*>(Pb);
  p.q = static_cast<const float*>(q);
  p.y0 = static_cast<const float*>(y0);
  p.U = static_cast<const float*>(U);
  p.bs = static_cast<const float*>(b_pairs);
  p.nsc = static_cast<const float*>(nsc);
  p.scale = static_cast<const float*>(scale);
  p.bpl = static_cast<const float*>(b_pl);
  p.F = static_cast<const float*>(F_seg);
  p.sig = static_cast<const float*>(sigma);
  p.y_out = static_cast<float*>(y);
  p.lam_s = static_cast<float*>(lam_s);
  p.lam_p = static_cast<float*>(lam_p);
  p.gap = static_cast<float*>(gap);
  p.it_out = static_cast<int*>(iters_used);
  p.scratch = static_cast<float*>(scratch);
  p.slab = pl.slab;
  p.rows_smem = pl.rows_smem;
  p.qpb = pl.qpb;
  p.N = N;
  p.nf = nf;
  p.Ru = Ru;
  p.C = C;
  p.M = M;
  p.n1 = n1;
  p.iters = iters;
  p.correctors = correctors;
  p.reg = reg;
  p.s_min = s_min;
  p.tol_gap = tol_gap;
  p.tol_rp = tol_rp;
  p.tol_rd = tol_rd;
  p.tol_step = tol_step;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 2 ? launch_d<2>(p, pl, st) : launch_d<3>(p, pl, st);
}

}  // extern "C"
