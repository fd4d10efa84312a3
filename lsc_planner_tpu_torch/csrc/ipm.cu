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
// 0.05) on the same factor, the NaN guard, the per-QP latch, and the exit
// test on the new iterate.  The plain PyTorch transcription is
// lsc_planner_tpu_torch/ops/ipm.py::ipm_lsc_fused_plain.
//
// What bounds it on an H100: latency, not FLOPs or bytes.  One iteration
// is ~1.5e5 FLOPs a QP (the Gram ~1.3e5, the factor ~2e4, the row
// products), and a QP's input is ~60 KB at C = 32, read once.  The time is
// made of dependent steps: 39 Cholesky columns with two block barriers
// each, three 39-step triangular substitution chains, and ~20 block-wide
// min/sum/max reductions an iteration, for up to 40 iterations.
//
// What the design does about that: one thread block per QP (grid = N; the
// TPU's 128-lane batch axis has no counterpart on Hopper), and every
// iterate -- slacks, duals, both direction sets, the pre-scaled normals,
// the bounds, the Gram and its factor, the shared U and F_seg tables -- is
// kept in shared memory for the whole solve (88 KB at C = 32, 138 KB at
// C = 64).  Nothing but the problem and the solution crosses device memory.
// The Gram blocks are formed directly from the rows, without the TPU's
// UU/FF outer-product tables.  The Gondzio candidate and the current
// direction live in two buffer sets, and a kept candidate swaps the two
// instead of copying.  A QP leaves its loop as soon as it latches done;
// the wrapper turns the per-QP counts into the TPU kernel's per-tile ones.
// Several QPs per block, a warp-level factor and TMA loads of the row
// tensors are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (lsc_planner_tpu_torch/ops/_build.py).
// Interface: plain C, pointers to contiguous float32 device memory, the
// CUDA stream as an opaque pointer; the entry point returns
// cudaGetLastError() (or the error of the shared-memory attribute call).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNv = 64;       // two rows per lane in the one-warp solves
constexpr int kMaxC = 64;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// jnp.minimum / jnp.maximum: a NaN operand gives NaN
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

struct OpSum {
  __device__ static float id() { return 0.f; }
  __device__ static float f(float a, float b) { return a + b; }
};
struct OpMin {
  __device__ static float id() { return INFINITY; }
  __device__ static float f(float a, float b) { return jmin(a, b); }
};
struct OpMax {
  __device__ static float id() { return -INFINITY; }
  __device__ static float f(float a, float b) { return jmax(a, b); }
};

template <class Op>
__device__ __forceinline__ float warp_reduce(float v) {
  for (int o = 16; o > 0; o >>= 1) v = Op::f(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Two block-wide reductions at once; every thread gets both results.  Two
// barriers: the results sit in slots no later call writes before its own
// first barrier, so no third barrier is needed.
template <class Op>
__device__ float2 block_reduce2(float a, float b, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  a = warp_reduce<Op>(a);
  b = warp_reduce<Op>(b);
  if (lane == 0) {
    red[w] = a;
    red[kWarps + w] = b;
  }
  __syncthreads();
  if (w == 0) {
    a = lane < kWarps ? red[lane] : Op::id();
    b = lane < kWarps ? red[kWarps + lane] : Op::id();
    a = warp_reduce<Op>(a);
    b = warp_reduce<Op>(b);
    if (lane == 0) {
      red[2 * kWarps] = a;
      red[2 * kWarps + 1] = b;
    }
  }
  __syncthreads();
  return make_float2(red[2 * kWarps], red[2 * kWarps + 1]);
}

struct Params {
  const float *Pb, *q, *y0, *U, *bs, *nsc, *scale, *bpl, *F, *sig;
  float *y_out, *lam_s, *lam_p, *gap;
  int* it_out;
  int N, nf, Ru, C, M, n1, iters, correctors;
  float reg, s_min, tol_gap, tol_rp, tol_rd, tol_step;
};

// One direction set: slack and dual steps, the complementarity rhs it was
// solved for, and the primal step.  The KKT solve stages its row weights
// in dl_sp / dl_pl before it writes the steps there.
struct Dirs {
  float *ds_sp, *ds_sm, *ds_pl, *dl_sp, *dl_sm, *dl_pl, *rc_sp, *rc_sm,
      *rc_pl, *dy;
};

struct Smem {
  float *U, *F, *Pb, *q, *y, *rd, *dsc, *tmp, *H, *col, *xb, *vk, *W, *red,
      *flag;
  float *bs0, *bs1, *su, *s_sp, *s_sm, *l_sp, *l_sm, *dpair;
  float *nscs, *bpl, *plv, *s_pl, *l_pl;
  Dirs dir[2];
};

struct Carver {
  uintptr_t base;
  size_t off;
  __host__ __device__ float* take(int n) {
    float* p = reinterpret_cast<float*>(base + off * sizeof(float));
    off += static_cast<size_t>((n + 3) & ~3);      // 16-byte aligned slices
    return p;
  }
};

// Lays the shared memory out; returns its size in bytes.
__host__ __device__ size_t carve(uintptr_t base, int nf, int Ru, int C,
                                 int M, int n1, Smem* s) {
  const int MI = M * n1, R = C * MI, S = 3 * Ru, nv = 3 * nf;
  Carver c{base, 0};
  s->U = c.take(S * nf);
  s->F = c.take(MI * nf);
  s->Pb = c.take(nf * nf);
  s->q = c.take(nv);
  s->y = c.take(nv);
  s->rd = c.take(nv);
  s->dsc = c.take(nv);
  s->tmp = c.take(nv);
  s->H = c.take(nv * nv);
  s->col = c.take(nv);
  s->xb = c.take(3 * MI);
  s->vk = c.take(3 * MI);
  s->W = c.take(6 * MI);
  s->red = c.take(2 * kWarps + 2);
  s->flag = c.take(4);
  s->bs0 = c.take(S);
  s->bs1 = c.take(S);
  s->su = c.take(S);
  s->s_sp = c.take(S);
  s->s_sm = c.take(S);
  s->l_sp = c.take(S);
  s->l_sm = c.take(S);
  s->dpair = c.take(S);
  s->nscs = c.take(3 * R);
  s->bpl = c.take(R);
  s->plv = c.take(R);
  s->s_pl = c.take(R);
  s->l_pl = c.take(R);
  for (int d = 0; d < 2; ++d) {
    Dirs& D = s->dir[d];
    D.ds_sp = c.take(S);
    D.ds_sm = c.take(S);
    D.dl_sp = c.take(S);
    D.dl_sm = c.take(S);
    D.rc_sp = c.take(S);
    D.rc_sm = c.take(S);
    D.ds_pl = c.take(R);
    D.dl_pl = c.take(R);
    D.rc_pl = c.take(R);
    D.dy = c.take(nv);
  }
  return c.off * sizeof(float);
}

// The (k, l) dimension pairs of the Gram's upper block triangle.
__constant__ int kPairK[6] = {0, 0, 0, 1, 1, 2};
__constant__ int kPairL[6] = {0, 1, 2, 1, 2, 2};

struct Ctx {
  Smem s;
  int nf, Ru, C, M, n1, MI, R, S, nv;
};

// xb[k, j] = F_seg[j, :] . v[k, :] -- the plane rows' per-dimension basis
// values of v.  No barrier.
__device__ void basis(const Ctx& c, const float* v) {
  for (int e = threadIdx.x; e < 3 * c.MI; e += kThreads) {
    const int k = e / c.MI, j = e - k * c.MI;
    float acc = 0.f;
    for (int f = 0; f < c.nf; ++f)
      acc += c.s.F[j * c.nf + f] * v[k * c.nf + f];
    c.s.xb[e] = acc;
  }
}

// value of static +row r at v
__device__ __forceinline__ float static_row(const Ctx& c, int r,
                                            const float* v) {
  const int k = r / c.Ru;
  float acc = 0.f;
  for (int f = 0; f < c.nf; ++f) acc += c.s.U[r * c.nf + f] * v[k * c.nf + f];
  return acc;
}

// value of plane row r from the basis values in xb
__device__ __forceinline__ float plane_row(const Ctx& c, int r) {
  const int j = r % c.MI;
  float v = c.s.nscs[r] * c.s.xb[j];
  v = v + c.s.nscs[c.R + r] * c.s.xb[c.MI + j];
  v = v + c.s.nscs[2 * c.R + r] * c.s.xb[2 * c.MI + j];
  return v;
}

// out = A^T w, with w_su the combined (+dual - -dual) static weights.
// Ends with a barrier.
__device__ void rmv(const Ctx& c, const float* w_su, const float* w_pl,
                    float* out) {
  for (int e = threadIdx.x; e < 3 * c.MI; e += kThreads) {
    const int k = e / c.MI, j = e - k * c.MI;
    const float* nk = c.s.nscs + k * c.R;
    float acc = 0.f;
    for (int ci = 0; ci < c.C; ++ci) {
      const int r = ci * c.MI + j;
      acc += nk[r] * w_pl[r];
    }
    c.s.vk[e] = acc;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < c.nv; t += kThreads) {
    const int k = t / c.nf, f = t - k * c.nf;
    float a = 0.f;
    for (int u = 0; u < c.Ru; ++u)
      a += c.s.U[(k * c.Ru + u) * c.nf + f] * w_su[k * c.Ru + u];
    float b = 0.f;
    for (int j = 0; j < c.MI; ++j)
      b += c.s.F[j * c.nf + f] * c.s.vk[k * c.MI + j];
    out[t] = a + b;
  }
  __syncthreads();
}

// (P y)[k, g] = sum_f Pb[f, g] y[k, f]
__device__ __forceinline__ float py(const Ctx& c, const float* y, int t) {
  const int k = t / c.nf, g = t - k * c.nf;
  float acc = 0.f;
  for (int f = 0; f < c.nf; ++f) acc += c.s.Pb[f * c.nf + g] * y[k * c.nf + f];
  return acc;
}

// H = P + A^T D A (D = lam / s), Jacobi-scaled with the ridge, unit
// diagonal forced to 1 + 1e-6, then factored in place (lower triangle)
// with the 1e-6 pivot floor.  dsc keeps the scaling.
__device__ void gram_factor(const Ctx& c, float reg) {
  const Smem& s = c.s;
  const int nf = c.nf, nv = c.nv, MI = c.MI, R = c.R;
  for (int r = threadIdx.x; r < c.S; r += kThreads)
    s.dpair[r] = s.l_sp[r] / s.s_sp[r] + s.l_sm[r] / s.s_sm[r];
  for (int e = threadIdx.x; e < 6 * MI; e += kThreads) {
    const int p = e / MI, j = e - p * MI;
    const float* nk = s.nscs + kPairK[p] * R;
    const float* nl = s.nscs + kPairL[p] * R;
    float acc = 0.f;
    for (int ci = 0; ci < c.C; ++ci) {
      const int r = ci * MI + j;
      acc += nk[r] * nl[r] * (s.l_pl[r] / s.s_pl[r]);
    }
    s.W[e] = acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 6 * nf * nf; e += kThreads) {
    const int p = e / (nf * nf), fg = e - p * nf * nf;
    const int f = fg / nf, g = fg - f * nf;
    const int k = kPairK[p], l = kPairL[p];
    float acc = 0.f;
    for (int j = 0; j < MI; ++j)
      acc += s.F[j * nf + f] * s.F[j * nf + g] * s.W[p * MI + j];
    if (k == l) {
      float hst = 0.f;
      for (int u = 0; u < c.Ru; ++u) {
        const int ru = k * c.Ru + u;
        hst += s.U[ru * nf + f] * s.U[ru * nf + g] * s.dpair[ru];
      }
      acc = acc + hst + s.Pb[f * nf + g];
    }
    s.H[(k * nf + f) * nv + l * nf + g] = acc;
    if (k != l) s.H[(l * nf + g) * nv + k * nf + f] = acc;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float v = 0.f;
    for (int i = lane; i < nv; i += 32) v += s.H[i * nv + i];
    v = warp_reduce<OpSum>(v);
    const float ridge = reg * jmax(v / static_cast<float>(nv), 1.f);
    for (int i = lane; i < nv; i += 32)
      s.dsc[i] = 1.f / sqrtf(s.H[i * nv + i] + ridge);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nv * nv; e += kThreads) {
    const int i = e / nv, j = e - i * nv;
    if (j < i)
      s.H[e] = s.H[e] * s.dsc[i] * s.dsc[j];
    else if (j == i)
      s.H[e] = 1.f + 1e-6f;
  }
  __syncthreads();
  for (int k = 0; k < nv; ++k) {
    const float piv = s.H[k * nv + k];
    const float dk = piv < 1e-6f ? 1e-6f : piv;     // NaN stays NaN
    const float inv = 1.f / sqrtf(dk);
    for (int i = k + threadIdx.x; i < nv; i += kThreads)
      s.col[i] = s.H[i * nv + k] * inv;
    __syncthreads();
    const int m = nv - k - 1;
    for (int e = threadIdx.x; e < m * m; e += kThreads) {
      const int i = k + 1 + e / m, j = k + 1 + e % m;
      if (j <= i) s.H[i * nv + j] -= s.col[i] * s.col[j];
    }
    for (int i = k + threadIdx.x; i < nv; i += kThreads)
      s.H[i * nv + k] = s.col[i];
    __syncthreads();
  }
}

// (L L^T) x = z with warp 0; L row-major lower in shared memory, z and x
// in registers (lane l holds rows l and l + 32).
__device__ void solve_warp(const float* L, int n, float& z0, float& z1) {
  const int r0 = threadIdx.x & 31, r1 = r0 + 32;
  for (int k = 0; k < n; ++k) {
    const float held = k < 32 ? z0 : z1;
    const float zk = __shfl_sync(kFull, held, k & 31) / L[k * n + k];
    if (r0 == k) z0 = zk;
    if (r1 == k) z1 = zk;
    if (r0 > k && r0 < n) z0 -= L[r0 * n + k] * zk;
    if (r1 > k && r1 < n) z1 -= L[r1 * n + k] * zk;
  }
  for (int k = n - 1; k >= 0; --k) {
    const float held = k < 32 ? z0 : z1;
    const float xk = __shfl_sync(kFull, held, k & 31) / L[k * n + k];
    if (r0 == k) z0 = xk;
    if (r1 == k) z1 = xk;
    if (r0 < k) z0 -= L[k * n + r0] * xk;
    if (r1 < k) z1 -= L[k * n + r1] * xk;
  }
}

// Newton direction for the complementarity rhs in D.rc_*: fills D.dy,
// D.ds_*, D.dl_*, and flag[d] = 1 when dy is not finite.  Ends with a
// barrier.
__device__ void kkt(const Ctx& c, int d) {
  const Smem& s = c.s;
  const Dirs& D = s.dir[d];
  float* w_su = D.dl_sp;           // staged row weights, consumed by rmv
  float* w_pl = D.dl_pl;
  for (int r = threadIdx.x; r < c.S; r += kThreads) {
    const float rp_sp = s.su[r] - s.s_sp[r] - s.bs0[r];
    const float rp_sm = -s.su[r] - s.s_sm[r] - s.bs1[r];
    w_su[r] = (D.rc_sp[r] + s.l_sp[r] * rp_sp) / s.s_sp[r] -
              (D.rc_sm[r] + s.l_sm[r] * rp_sm) / s.s_sm[r];
  }
  for (int r = threadIdx.x; r < c.R; r += kThreads) {
    const float rp_pl = s.plv[r] - s.s_pl[r] - s.bpl[r];
    w_pl[r] = (D.rc_pl[r] + s.l_pl[r] * rp_pl) / s.s_pl[r];
  }
  __syncthreads();
  rmv(c, w_su, w_pl, s.tmp);
  if (threadIdx.x < 32) {
    const int r0 = threadIdx.x, r1 = r0 + 32;
    float z0 = r0 < c.nv ? s.dsc[r0] * (-s.rd[r0] - s.tmp[r0]) : 0.f;
    float z1 = r1 < c.nv ? s.dsc[r1] * (-s.rd[r1] - s.tmp[r1]) : 0.f;
    solve_warp(s.H, c.nv, z0, z1);
    bool bad = false;
    if (r0 < c.nv) {
      const float v = s.dsc[r0] * z0;
      D.dy[r0] = v;
      bad = bad || !isfinite(v);
    }
    if (r1 < c.nv) {
      const float v = s.dsc[r1] * z1;
      D.dy[r1] = v;
      bad = bad || !isfinite(v);
    }
    bad = __any_sync(kFull, bad);
    if (r0 == 0) s.flag[d] = bad ? 1.f : 0.f;
  }
  __syncthreads();
  basis(c, D.dy);
  __syncthreads();
  for (int r = threadIdx.x; r < c.S; r += kThreads) {
    const float dsu = static_row(c, r, D.dy);
    const float ds_sp = dsu + (s.su[r] - s.s_sp[r] - s.bs0[r]);
    const float ds_sm = -dsu + (-s.su[r] - s.s_sm[r] - s.bs1[r]);
    D.ds_sp[r] = ds_sp;
    D.ds_sm[r] = ds_sm;
    D.dl_sp[r] = -(D.rc_sp[r] + s.l_sp[r] * ds_sp) / s.s_sp[r];
    D.dl_sm[r] = -(D.rc_sm[r] + s.l_sm[r] * ds_sm) / s.s_sm[r];
  }
  for (int r = threadIdx.x; r < c.R; r += kThreads) {
    const float ds_pl = plane_row(c, r) + (s.plv[r] - s.s_pl[r] - s.bpl[r]);
    D.ds_pl[r] = ds_pl;
    D.dl_pl[r] = -(D.rc_pl[r] + s.l_pl[r] * ds_pl) / s.s_pl[r];
  }
  __syncthreads();
}

__device__ __forceinline__ float ratio(float v, float dv) {
  return dv < 0.f ? -v / dv : INFINITY;
}

// (alpha_p, alpha_d): largest step in (0, 1] keeping slacks / duals above
// (1 - 0.995) of their value
__device__ float2 step_lens(const Ctx& c, int d) {
  const Smem& s = c.s;
  const Dirs& D = s.dir[d];
  float mp = INFINITY, md = INFINITY;
  for (int r = threadIdx.x; r < c.S; r += kThreads) {
    mp = jmin(mp, jmin(ratio(s.s_sp[r], D.ds_sp[r]),
                       ratio(s.s_sm[r], D.ds_sm[r])));
    md = jmin(md, jmin(ratio(s.l_sp[r], D.dl_sp[r]),
                       ratio(s.l_sm[r], D.dl_sm[r])));
  }
  for (int r = threadIdx.x; r < c.R; r += kThreads) {
    mp = jmin(mp, ratio(s.s_pl[r], D.ds_pl[r]));
    md = jmin(md, ratio(s.l_pl[r], D.dl_pl[r]));
  }
  const float2 m = block_reduce2<OpMin>(mp, md, s.red);
  return make_float2(jmin(1.f, 0.995f * m.x), jmin(1.f, 0.995f * m.y));
}

// sum over all rows of (s + a_p ds)(l + a_d dl) (a_p = a_d = 0: s l)
__device__ float complementarity(const Ctx& c, const Dirs& D, float a_p,
                                 float a_d, bool with_step) {
  const Smem& s = c.s;
  float acc = 0.f;
  for (int r = threadIdx.x; r < c.S; r += kThreads) {
    if (with_step) {
      acc += (s.s_sp[r] + a_p * D.ds_sp[r]) * (s.l_sp[r] + a_d * D.dl_sp[r]);
      acc += (s.s_sm[r] + a_p * D.ds_sm[r]) * (s.l_sm[r] + a_d * D.dl_sm[r]);
    } else {
      acc += s.s_sp[r] * s.l_sp[r] + s.s_sm[r] * s.l_sm[r];
    }
  }
  for (int r = threadIdx.x; r < c.R; r += kThreads) {
    if (with_step)
      acc += (s.s_pl[r] + a_p * D.ds_pl[r]) * (s.l_pl[r] + a_d * D.dl_pl[r]);
    else
      acc += s.s_pl[r] * s.l_pl[r];
  }
  return block_reduce2<OpSum>(acc, 0.f, s.red).x;
}

// Recompute the row values su / plv of y and the dual residual
// r_d = P y + q - A^T lam.  Ends with a barrier.
__device__ void rows_and_residual(const Ctx& c) {
  const Smem& s = c.s;
  float* w_su = s.dir[0].dl_sp;        // free between iterations
  basis(c, s.y);
  __syncthreads();
  for (int r = threadIdx.x; r < c.S; r += kThreads) {
    s.su[r] = static_row(c, r, s.y);
    w_su[r] = s.l_sp[r] - s.l_sm[r];
  }
  for (int r = threadIdx.x; r < c.R; r += kThreads) s.plv[r] = plane_row(c, r);
  __syncthreads();
  rmv(c, w_su, s.l_pl, s.tmp);
  for (int t = threadIdx.x; t < c.nv; t += kThreads)
    s.rd[t] = (py(c, s.y, t) + s.q[t]) - s.tmp[t];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) ipm_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ctx c;
  c.nf = p.nf;
  c.Ru = p.Ru;
  c.C = p.C;
  c.M = p.M;
  c.n1 = p.n1;
  c.MI = p.M * p.n1;
  c.R = p.C * c.MI;
  c.S = 3 * p.Ru;
  c.nv = 3 * p.nf;
  carve(reinterpret_cast<uintptr_t>(smem_raw), p.nf, p.Ru, p.C, p.M, p.n1,
        &c.s);
  const Smem& s = c.s;
  const int tid = threadIdx.x;
  const int nf = c.nf, nv = c.nv, S = c.S, R = c.R, MI = c.MI;
  const size_t b = blockIdx.x;

  // ---- the problem, into shared memory ----
  for (int e = tid; e < S * nf; e += kThreads) s.U[e] = p.U[e];
  for (int e = tid; e < MI * nf; e += kThreads) s.F[e] = p.F[e];
  for (int e = tid; e < nf * nf; e += kThreads)
    s.Pb[e] = p.Pb[b * nf * nf + e];
  for (int e = tid; e < nv; e += kThreads) {
    s.q[e] = p.q[b * nv + e];
    s.y[e] = p.y0[b * nv + e];
  }
  for (int e = tid; e < S; e += kThreads) {
    s.bs0[e] = p.bs[b * 2 * S + e];
    s.bs1[e] = p.bs[b * 2 * S + S + e];
  }
  for (int r = tid; r < R; r += kThreads) {
    // plane row r = (c, m, i), c-major; normals pre-scaled by the row scale
    const int ci = r / MI, rem = r - ci * MI;
    const int m = rem / c.n1, i = rem - m * c.n1;
    const size_t base = (b * c.C + ci) * c.M + m;
    const float sc = p.scale[base * c.n1 + i];
    for (int k = 0; k < 3; ++k) s.nscs[k * R + r] = p.nsc[base * 3 + k] * sc;
    s.bpl[r] = p.bpl[base * c.n1 + i];
  }
  const float sig = p.sig[b];
  __syncthreads();

  // ---- initial point: slacks from the start y, unit duals ----
  basis(c, s.y);
  __syncthreads();
  for (int r = tid; r < S; r += kThreads) {
    const float su = static_row(c, r, s.y);
    s.su[r] = su;
    s.s_sp[r] = jmax(su - s.bs0[r], p.s_min);
    s.s_sm[r] = jmax(-su - s.bs1[r], p.s_min);
    s.l_sp[r] = 1.f;
    s.l_sm[r] = 1.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    const float pv = plane_row(c, r);
    s.plv[r] = pv;
    s.s_pl[r] = jmax(pv - s.bpl[r], p.s_min);
    s.l_pl[r] = 1.f;
  }
  __syncthreads();
  rows_and_residual(c);
  const float nr = static_cast<float>(2 * S + R);
  float mu = complementarity(c, s.dir[0], 0.f, 0.f, false) / nr;

  bool done = false;                 // block-uniform: from broadcasts only
  int it_used = p.iters;
  for (int it = 0; it < p.iters && !done; ++it) {
    gram_factor(c, p.reg);

    // predictor (affine scaling), direction set 0
    {
      const Dirs& A = s.dir[0];
      for (int r = tid; r < S; r += kThreads) {
        A.rc_sp[r] = s.s_sp[r] * s.l_sp[r];
        A.rc_sm[r] = s.s_sm[r] * s.l_sm[r];
      }
      for (int r = tid; r < R; r += kThreads)
        A.rc_pl[r] = s.s_pl[r] * s.l_pl[r];
      __syncthreads();
    }
    kkt(c, 0);
    float2 a = step_lens(c, 0);
    const float mu_aff = complementarity(c, s.dir[0], a.x, a.y, true) / nr;
    float sigma = mu_aff / jmax(mu, 1e-30f);
    sigma = sigma * sigma * sigma;
    const float smu = sigma * mu;

    // corrector, direction set 1
    {
      const Dirs& A = s.dir[0];
      const Dirs& B = s.dir[1];
      for (int r = tid; r < S; r += kThreads) {
        B.rc_sp[r] = A.rc_sp[r] + A.ds_sp[r] * A.dl_sp[r] - smu;
        B.rc_sm[r] = A.rc_sm[r] + A.ds_sm[r] * A.dl_sm[r] - smu;
      }
      for (int r = tid; r < R; r += kThreads)
        B.rc_pl[r] = A.rc_pl[r] + A.ds_pl[r] * A.dl_pl[r] - smu;
      __syncthreads();
    }
    kkt(c, 1);
    a = step_lens(c, 1);
    float a_p = a.x, a_d = a.y;

    // Gondzio correctors: candidate in the other set, kept by a swap.  The
    // TPU kernel mixes candidate and current with 0/1 weights, so a
    // non-finite step in either turns the mixed step into NaN and the NaN
    // guard below rejects the iteration: `poison` carries that.
    int cur = 1;
    bool poison = false;
    const float lo = 0.1f * smu, hi = 10.f * smu;
    for (int g = 0; g < p.correctors; ++g) {
      const Dirs& X = s.dir[cur];
      const Dirs& Y = s.dir[1 - cur];
      for (int r = tid; r < S; r += kThreads) {
        float prod = (s.s_sp[r] + a_p * X.ds_sp[r]) *
                     (s.l_sp[r] + a_d * X.dl_sp[r]);
        Y.rc_sp[r] = X.rc_sp[r] + (jmin(jmax(prod, lo), hi) - prod);
        prod = (s.s_sm[r] + a_p * X.ds_sm[r]) * (s.l_sm[r] + a_d * X.dl_sm[r]);
        Y.rc_sm[r] = X.rc_sm[r] + (jmin(jmax(prod, lo), hi) - prod);
      }
      for (int r = tid; r < R; r += kThreads) {
        const float prod = (s.s_pl[r] + a_p * X.ds_pl[r]) *
                           (s.l_pl[r] + a_d * X.dl_pl[r]);
        Y.rc_pl[r] = X.rc_pl[r] + (jmin(jmax(prod, lo), hi) - prod);
      }
      __syncthreads();
      kkt(c, 1 - cur);
      const float2 a2 = step_lens(c, 1 - cur);
      poison = poison || s.flag[0] != 0.f || s.flag[1] != 0.f ||
               !isfinite(a2.x) || !isfinite(a2.y);
      if (a2.x + a2.y > a_p + a_d + 0.05f) {
        cur = 1 - cur;
        a_p = a2.x;
        a_d = a2.y;
      }
    }
    const Dirs& D = s.dir[cur];

    // step, NaN guard (warp 0 decides, everyone reads the flag)
    if (tid < 32) {
      float m = -INFINITY;
      bool fin = true;
      for (int i = tid; i < nv; i += 32) {
        m = jmax(m, fabsf(D.dy[i]));
        fin = fin && isfinite(s.y[i] + a_p * D.dy[i]);
      }
      m = warp_reduce<OpMax>(m);
      fin = __all_sync(kFull, fin);
      const bool ok = fin && isfinite(a_p) && isfinite(a_d) &&
                      isfinite(mu_aff) && isfinite(sigma) && !poison;
      if (ok)
        for (int i = tid; i < nv; i += 32) s.y[i] = s.y[i] + a_p * D.dy[i];
      if (tid == 0) {
        s.flag[2] = ok ? 1.f : 0.f;
        s.flag[3] = a_p * m;
      }
    }
    __syncthreads();
    if (s.flag[2] == 0.f) continue;      // rejected: iterate unchanged
    const float step_disp = s.flag[3];
    for (int r = tid; r < S; r += kThreads) {
      s.s_sp[r] = jmax(s.s_sp[r] + a_p * D.ds_sp[r], 1e-12f);
      s.s_sm[r] = jmax(s.s_sm[r] + a_p * D.ds_sm[r], 1e-12f);
      s.l_sp[r] = jmax(s.l_sp[r] + a_d * D.dl_sp[r], 1e-12f);
      s.l_sm[r] = jmax(s.l_sm[r] + a_d * D.dl_sm[r], 1e-12f);
    }
    for (int r = tid; r < R; r += kThreads) {
      s.s_pl[r] = jmax(s.s_pl[r] + a_p * D.ds_pl[r], 1e-12f);
      s.l_pl[r] = jmax(s.l_pl[r] + a_d * D.dl_pl[r], 1e-12f);
    }
    __syncthreads();

    // exit test on the new iterate; its row values and r_d are the next
    // iteration's
    rows_and_residual(c);
    float acc = 0.f, rpm = -INFINITY, rdm = -INFINITY;
    for (int r = tid; r < S; r += kThreads) {
      acc += s.s_sp[r] * s.l_sp[r] + s.s_sm[r] * s.l_sm[r];
      rpm = jmax(rpm, fabsf(s.su[r] - s.s_sp[r] - s.bs0[r]));
      rpm = jmax(rpm, fabsf(-s.su[r] - s.s_sm[r] - s.bs1[r]));
    }
    for (int r = tid; r < R; r += kThreads) {
      acc += s.s_pl[r] * s.l_pl[r];
      rpm = jmax(rpm, fabsf(s.plv[r] - s.s_pl[r] - s.bpl[r]));
    }
    for (int t = tid; t < nv; t += kThreads) rdm = jmax(rdm, fabsf(s.rd[t]));
    mu = block_reduce2<OpSum>(acc, 0.f, s.red).x / nr;
    const float2 mx = block_reduce2<OpMax>(rpm, rdm, s.red);
    if (mu < p.tol_gap * sig && mx.x < p.tol_rp &&
        (mx.y < p.tol_rd || step_disp < p.tol_step)) {
      done = true;
      it_used = it + 1;
    }
  }

  // ---- the solution ----
  for (int t = tid; t < nv; t += kThreads) p.y_out[b * nv + t] = s.y[t];
  for (int r = tid; r < S; r += kThreads) {
    p.lam_s[b * 2 * S + r] = s.l_sp[r];
    p.lam_s[b * 2 * S + S + r] = s.l_sm[r];
  }
  for (int r = tid; r < R; r += kThreads) p.lam_p[b * R + r] = s.l_pl[r];
  const float gap = complementarity(c, s.dir[0], 0.f, 0.f, false) / nr;
  if (tid == 0) {
    p.gap[b] = gap;
    p.it_out[b] = it_used;
  }
}

}  // namespace

extern "C" {

int lsc_ipm_fused_f32(const void* Pb, const void* q, const void* y0,
                      const void* U, const void* b_pairs, const void* nsc,
                      const void* scale, const void* b_pl, const void* F_seg,
                      const void* sigma, void* y, void* lam_s, void* lam_p,
                      void* gap, void* iters_used, int N, int nf, int Ru,
                      int C, int M, int n1, int iters, int correctors,
                      float reg, float s_min, float tol_gap, float tol_rp,
                      float tol_rd, float tol_step, void* stream) {
  if (N < 0 || nf < 1 || 3 * nf > kMaxNv || Ru < 1 || C < 1 || C > kMaxC ||
      M < 1 || n1 < 1 || iters < 0 || correctors < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  Smem layout;
  const size_t bytes = carve(0, nf, Ru, C, M, n1, &layout);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ipm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
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
  ipm_kernel<<<N, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
