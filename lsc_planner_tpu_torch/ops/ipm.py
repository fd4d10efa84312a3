"""The fused whole-IPM solve of the factored LSC rows, with its plain version.

Port of the JAX package's TPU kernel ``ops/ipm_pallas.py::_ipm_kernel``
(wrapper ``ipm_lsc_fused``): the whole Mehrotra predictor-corrector solve,
every iteration, in one launch for the whole batch.  On a CUDA tensor
``ipm_lsc_fused`` launches the hand-written kernel (``csrc/ipm.cu``) or
raises; on a CPU tensor it runs ``ipm_lsc_fused_plain``.  There is no
fallback from one to the other.

The fused kernel is its own algorithm, not ``ops/qp.py::_ipm`` in one
launch.  It differs from ``_ipm`` in five ways, all kept here:
  * its Cholesky floors every pivot at 1e-6 (``_chol_floored``);
  * the Jacobi-scaled diagonal is overwritten with 1 + 1e-6;
  * the exit test runs on the NEW iterate, after the step, so the same
    iterate is reported with one iteration fewer than ``_ipm`` reports;
  * the NaN guard checks y, the step lengths, mu_aff and sigma only (no
    growth bounds) and leaves the step size of a rejected step in place;
  * a QP's reported iteration count is that of its tile: the most any QP
    among the 128 consecutive ones it shares a TPU lane tile with took.
The per-QP latch freezes a finished QP, so exiting per QP (the CUDA
kernel) or per tile (the TPU) gives the same y, duals and gap; only the
count needs the tile maximum, which ``tile_counts`` takes.

Shapes at the public surface are the JAX wrapper's, batch first:
P_blk (N, nf, nf); q, y0 (N, 3 nf); U (3, Ru, nf) pre-scaled unique static
+rows; b_pairs (N, 2, 3 Ru) [+rows, -rows] scaled bounds; nsc (N, C, M, 3)
plane normals; scale, b_pl (N, C, M, n+1) row scales (0 = masked) and
scaled bounds (-1 = masked); F_seg (M, n+1, nf); sigma (N,).
Returns (y (N, nv), lam_s (N, 2, 3 Ru), lam_p (N, C M (n+1)) c-major,
gap (N,), iters_used (N,) int32 tile counts).
"""
from __future__ import annotations

import torch

from . import _build

TILE = 128          # the TPU kernel's lane tile, the unit of its count
MAX_C = 64          # obstacle rows the kernel's shared memory is sized for
MAX_NV = 64         # the kernel's one-warp substitutions hold 2 rows a lane
PIVOT_FLOOR = 1e-6

# launches of the kernel since the last reset (CUDA only; the plain version
# never counts)
fused_launches = 0


def reset_counts() -> None:
    global fused_launches
    fused_launches = 0


def tile_counts(per_qp):
    """Per-QP iteration counts -> the count of each QP's 128-QP tile (the
    max over the tile, broadcast back), as the TPU kernel reports them."""
    N = per_qp.shape[0]
    pad = (-N) % TILE
    padded = torch.cat([per_qp, per_qp.new_zeros(pad)]) if pad else per_qp
    tiles = padded.reshape(-1, TILE).amax(-1, keepdim=True)
    return tiles.expand(-1, TILE).reshape(-1)[:N].contiguous()


# ----------------------------------------------------------------------
# plain version
# ----------------------------------------------------------------------
def _step_len(v, dv, tau: float = 0.995):
    """Largest alpha in (0, 1] with v + alpha dv >= (1 - tau) v, per QP;
    v and dv are lists of (N, rows) tensors."""
    alpha = None
    for vi, dvi in zip(v, dv):
        neg = dvi < 0.0
        ratio = torch.where(neg, -vi / torch.where(neg, dvi, -1.0),
                            torch.full_like(vi, float("inf")))
        m = ratio.amin(-1)
        alpha = m if alpha is None else torch.minimum(alpha, m)
    return torch.minimum(torch.ones_like(alpha), tau * alpha)


def _chol_floored(Hs):
    """Lower Cholesky with every pivot floored at 1e-6 (``_chol_into``)."""
    n = Hs.shape[-1]
    A = Hs.clone()
    L = torch.zeros_like(Hs)
    rows = torch.arange(n, device=Hs.device)
    for k in range(n):
        dk = torch.clamp(A[:, k, k], min=PIVOT_FLOOR)
        col = A[:, :, k] * torch.rsqrt(dk)[:, None]
        col = torch.where(rows >= k, col, torch.zeros_like(col))
        L[:, :, k] = col
        A = A - col[:, :, None] * col[:, None, :]
    return L


def _solve(L, rhs):
    z = torch.linalg.solve_triangular(L, rhs.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(L.mT, z, upper=True).squeeze(-1)


def _rowsum(*xs):
    total = None
    for x in xs:
        total = x.sum(-1) if total is None else total + x.sum(-1)
    return total


def _rowmax(*xs):
    return torch.stack([x.amax(-1) for x in xs]).amax(0)


def ipm_lsc_fused_plain(P_blk, q, y0, U, b_pairs, nsc, scale, b_pl, F_seg,
                        sigma=None, *, iters: int = 14, reg: float = 1e-8,
                        s_min: float = 1.0, tol_gap: float = 1e-3,
                        tol_rp: float = 1e-4, tol_rd: float = 0.05,
                        tol_step: float = 0.0, correctors: int = 0):
    """Plain PyTorch transcription of ``_ipm_kernel``'s arithmetic, batch
    first, in the dtype it is given (the kernel's oracle; f64 for a
    reference).  Same arguments and returns as ``ipm_lsc_fused``."""
    N, nf = P_blk.shape[0], P_blk.shape[-1]
    ndim, Ru = U.shape[0], U.shape[1]
    C, M, n1 = nsc.shape[1], nsc.shape[2], scale.shape[-1]
    MI = M * n1
    R = C * MI
    nv = ndim * nf
    dtype, dev = q.dtype, q.device
    Pb = P_blk
    bs = b_pairs
    Fseg = F_seg.reshape(MI, nf)
    sig = torch.ones(N, dtype=dtype, device=dev) if sigma is None else sigma
    # normals pre-expanded over the control-point index and pre-scaled:
    # nscs[:, k, (c, m, i)] = nsc[:, c, m, k] * scale[:, c, m, i]
    nscs = (nsc.permute(0, 3, 1, 2)[..., None] *
            scale[:, None]).reshape(N, ndim, R)
    bpl = b_pl.reshape(N, R)

    def mv(y):
        y3 = y.reshape(N, ndim, nf)
        su = torch.einsum("kuf,nkf->nku", U, y3).reshape(N, ndim * Ru)
        x = torch.einsum("jf,nkf->nkj", Fseg, y3)                # (N, k, MI)
        xt = x[:, :, None, :].expand(N, ndim, C, MI).reshape(N, ndim, R)
        pl = nscs[:, 0] * xt[:, 0]
        for k in range(1, ndim):
            pl = pl + nscs[:, k] * xt[:, k]
        return su, pl

    def rmv(w_su, w_pl):
        r_st = torch.einsum("kuf,nku->nkf", U, w_su.reshape(N, ndim, Ru))
        v = (nscs * w_pl[:, None]).reshape(N, ndim, C, MI).sum(2)
        r_pl = torch.einsum("jf,nkj->nkf", Fseg, v)
        return (r_st + r_pl).reshape(N, nv)

    def gram(d_su, d_pl):
        d3 = d_su.reshape(N, ndim, Ru)
        H = torch.empty((N, nv, nv), dtype=dtype, device=dev)
        for k in range(ndim):
            for li in range(k, ndim):
                W = (nscs[:, k] * nscs[:, li] * d_pl).reshape(
                    N, C, MI).sum(1)
                Hkl = torch.einsum("jf,jg,nj->nfg", Fseg, Fseg, W)
                if li == k:
                    Hst = torch.einsum("uf,ug,nu->nfg", U[k], U[k], d3[:, k])
                    Hkl = Hkl + Hst + Pb
                H[:, k * nf:(k + 1) * nf, li * nf:(li + 1) * nf] = Hkl
                if li != k:
                    H[:, li * nf:(li + 1) * nf, k * nf:(k + 1) * nf] = \
                        Hkl.mT
        return H

    def Py(y):
        return torch.einsum("nfg,nkf->nkg", Pb,
                            y.reshape(N, ndim, nf)).reshape(N, nv)

    y = y0.clone()
    su, plv = mv(y)
    s_sp = torch.clamp(su - bs[:, 0], min=s_min)
    s_sm = torch.clamp(-su - bs[:, 1], min=s_min)
    s_pl = torch.clamp(plv - bpl, min=s_min)
    l_sp, l_sm, l_pl = (torch.ones_like(s_sp), torch.ones_like(s_sm),
                        torch.ones_like(s_pl))
    nr = 2 * ndim * Ru + R
    eye = torch.eye(nv, dtype=torch.bool, device=dev)
    r_d = Py(y) + q - rmv(l_sp - l_sm, l_pl)
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    it_qp = torch.full((N,), iters, dtype=torch.int32, device=dev)
    exit_on = tol_gap > 0.0 and tol_rp > 0.0

    for it in range(iters):
        rp_sp = su - s_sp - bs[:, 0]
        rp_sm = -su - s_sm - bs[:, 1]
        rp_pl = plv - s_pl - bpl
        mu = _rowsum(s_sp * l_sp, s_sm * l_sm, s_pl * l_pl) / nr

        H = gram(l_sp / s_sp + l_sm / s_sm, l_pl / s_pl)
        diag = torch.diagonal(H, dim1=-2, dim2=-1)
        ridge = reg * torch.clamp(diag.sum(-1) / nv, min=1.0)
        dsc = torch.rsqrt(diag + ridge[:, None])
        Hs = H * dsc[:, :, None] * dsc[:, None, :]
        Hs = torch.where(eye, torch.full_like(Hs, 1.0 + 1e-6), Hs)
        L = _chol_floored(Hs)

        def kkt(rc_sp, rc_sm, rc_pl):
            w_su = (rc_sp + l_sp * rp_sp) / s_sp - \
                (rc_sm + l_sm * rp_sm) / s_sm
            w_pl = (rc_pl + l_pl * rp_pl) / s_pl
            rhs = -r_d - rmv(w_su, w_pl)
            dy = dsc * _solve(L, dsc * rhs)
            dsu, dpl = mv(dy)
            ds = (dsu + rp_sp, -dsu + rp_sm, dpl + rp_pl)
            dl = (-(rc_sp + l_sp * ds[0]) / s_sp,
                  -(rc_sm + l_sm * ds[1]) / s_sm,
                  -(rc_pl + l_pl * ds[2]) / s_pl)
            return dy, ds, dl

        svars, lvars = (s_sp, s_sm, s_pl), (l_sp, l_sm, l_pl)
        # predictor (affine scaling)
        rc = tuple(s * lv for s, lv in zip(svars, lvars))
        dy_a, ds_a, dl_a = kkt(*rc)
        a_p = _step_len(svars, ds_a)
        a_d = _step_len(lvars, dl_a)
        mu_aff = _rowsum(*[(s + a_p[:, None] * ds) * (lv + a_d[:, None] * dl)
                           for s, lv, ds, dl in zip(svars, lvars, ds_a,
                                                    dl_a)]) / nr
        sigma_c = (mu_aff / torch.clamp(mu, min=1e-30)) ** 3
        sm = (sigma_c * mu)[:, None]

        # corrector
        rc_c = tuple(r + ds * dl - sm for r, ds, dl in zip(rc, ds_a, dl_a))
        dy, ds, dl = kkt(*rc_c)
        a_p = _step_len(svars, ds)
        a_d = _step_len(lvars, dl)

        # Gondzio centrality correctors on the same factor; the TPU kernel
        # mixes candidate and current with 0/1 weights, kept as arithmetic
        for _ in range(correctors):
            rc_n = []
            for v in range(3):
                prod = (svars[v] + a_p[:, None] * ds[v]) * \
                    (lvars[v] + a_d[:, None] * dl[v])
                target = torch.minimum(torch.maximum(prod, 0.1 * sm),
                                       10.0 * sm)
                rc_n.append(rc_c[v] + (target - prod))
            dy2, ds2, dl2 = kkt(*rc_n)
            a_p2 = _step_len(svars, ds2)
            a_d2 = _step_len(lvars, dl2)
            better = (a_p2 + a_d2 > a_p + a_d + 0.05).to(dtype)
            nb = 1.0 - better
            b2, n2 = better[:, None], nb[:, None]
            dy = dy2 * b2 + dy * n2
            ds = tuple(a2 * b2 + a1 * n2 for a2, a1 in zip(ds2, ds))
            dl = tuple(a2 * b2 + a1 * n2 for a2, a1 in zip(dl2, dl))
            rc_c = tuple(a2 * b2 + a1 * n2 for a2, a1 in zip(rc_n, rc_c))
            a_p = a_p2 * better + a_p * nb
            a_d = a_d2 * better + a_d * nb

        step_disp = a_p * dy.abs().amax(-1)
        y_n = y + a_p[:, None] * dy
        s_n = [torch.clamp(s + a_p[:, None] * d, min=1e-12)
               for s, d in zip(svars, ds)]
        l_n = [torch.clamp(lv + a_d[:, None] * d, min=1e-12)
               for lv, d in zip(lvars, dl)]
        ok = (torch.isfinite(y_n).all(-1) & torch.isfinite(a_p) &
              torch.isfinite(a_d) & torch.isfinite(mu_aff) &
              torch.isfinite(sigma_c) & ~done)
        okc = ok[:, None]
        y = torch.where(okc, y_n, y)
        s_sp, s_sm, s_pl = [torch.where(okc, a, b)
                            for a, b in zip(s_n, svars)]
        l_sp, l_sm, l_pl = [torch.where(okc, a, b)
                            for a, b in zip(l_n, lvars)]

        # exit test on the new iterate (hoisted next-iteration mv and r_d)
        su, plv = mv(y)
        r_d = Py(y) + q - rmv(l_sp - l_sm, l_pl)
        mu_n = _rowsum(s_sp * l_sp, s_sm * l_sm, s_pl * l_pl) / nr
        rpm = _rowmax((su - s_sp - bs[:, 0]).abs(),
                      (-su - s_sm - bs[:, 1]).abs(),
                      (plv - s_pl - bpl).abs())
        rdm = r_d.abs().amax(-1)
        newly = ok & (mu_n < tol_gap * sig) & (rpm < tol_rp) & \
            ((rdm < tol_rd) | (step_disp < tol_step))
        it_qp = torch.where(newly & ~done,
                            torch.full_like(it_qp, it + 1), it_qp)
        done = done | newly
        if exit_on and (it + 1) % 8 == 0 and bool(done.all()):
            break

    gap = _rowsum(s_sp * l_sp, s_sm * l_sm, s_pl * l_pl) / nr
    return (y, torch.stack([l_sp, l_sm], dim=1), l_pl, gap,
            tile_counts(it_qp))


# ----------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------
def _check(P_blk, q, y0, U, b_pairs, nsc, scale, b_pl, F_seg, sigma):
    """Shapes, dtype and size bounds the kernel takes; raises otherwise."""
    tensors = dict(P_blk=P_blk, q=q, y0=y0, U=U, b_pairs=b_pairs, nsc=nsc,
                   scale=scale, b_pl=b_pl, F_seg=F_seg, sigma=sigma)
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"ipm_lsc_fused: {name} is {t.dtype}; the fused "
                            "IPM is float32 only, as the TPU kernel is")
        if t.device != q.device:
            raise ValueError(f"ipm_lsc_fused: {name} on {t.device}, q on "
                             f"{q.device}")
    ndim, Ru = U.shape[0], U.shape[1]
    if ndim != 3 or nsc.shape[-1] != 3:
        raise NotImplementedError("ipm_lsc_fused: the 2-D layout is not "
                                  "ported (ROADMAP queue 1, item 12)")
    N, nf = P_blk.shape[0], P_blk.shape[-1]
    C, M, n1 = nsc.shape[1], nsc.shape[2], scale.shape[-1]
    nv = ndim * nf
    if C > MAX_C:
        raise NotImplementedError(
            f"ipm_lsc_fused: C = {C} obstacle rows; the kernel keeps at most "
            f"{MAX_C} in shared memory (use K-NN pruning, max_neighbors <= "
            f"{MAX_C}; more rows: ROADMAP queue 2, item 1)")
    if C < 1:
        raise ValueError(f"ipm_lsc_fused: C = {C} obstacle rows")
    if nv > MAX_NV:
        raise ValueError(f"ipm_lsc_fused: nv = {nv} > {MAX_NV}")
    want = dict(P_blk=(N, nf, nf), q=(N, nv), y0=(N, nv), U=(ndim, Ru, nf),
                b_pairs=(N, 2, ndim * Ru), nsc=(N, C, M, 3),
                scale=(N, C, M, n1), b_pl=(N, C, M, n1), F_seg=(M, n1, nf),
                sigma=(N,))
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"ipm_lsc_fused: {name} "
                             f"{tuple(tensors[name].shape)}, expected "
                             f"{shape}")
    return N, nf, Ru, C, M, n1


def _fused_cuda(P_blk, q, y0, U, b_pairs, nsc, scale, b_pl, F_seg, sigma,
                *, iters, reg, s_min, tol_gap, tol_rp, tol_rd, tol_step,
                correctors):
    global fused_launches
    lib = _build.load_library()
    N, nf, Ru, C, M, n1 = _check(P_blk, q, y0, U, b_pairs, nsc, scale, b_pl,
                                 F_seg, sigma)
    nv, R = 3 * nf, C * M * n1
    ins = [t.contiguous() for t in (P_blk, q, y0, U, b_pairs, nsc, scale,
                                    b_pl, F_seg, sigma)]
    y = torch.empty((N, nv), dtype=torch.float32, device=q.device)
    lam_s = torch.empty((N, 2, 3 * Ru), dtype=torch.float32, device=q.device)
    lam_p = torch.empty((N, R), dtype=torch.float32, device=q.device)
    gap = torch.empty((N,), dtype=torch.float32, device=q.device)
    it_qp = torch.empty((N,), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.lsc_ipm_fused_f32(
            *[t.data_ptr() for t in ins],
            y.data_ptr(), lam_s.data_ptr(), lam_p.data_ptr(), gap.data_ptr(),
            it_qp.data_ptr(), N, nf, Ru, C, M, n1, iters, correctors,
            reg, s_min, tol_gap, tol_rp, tol_rd, tol_step, stream)
    if err:
        raise RuntimeError(f"ipm_lsc_fused kernel launch failed: CUDA error "
                           f"{err}")
    fused_launches += 1
    return y, lam_s, lam_p, gap, tile_counts(it_qp)


# ----------------------------------------------------------------------
# wrapper
# ----------------------------------------------------------------------
def ipm_lsc_fused(P_blk, q, y0, U, b_pairs, nsc, scale, b_pl, F_seg,
                  sigma=None, *, iters: int = 14, reg: float = 1e-8,
                  s_min: float = 1.0, tol_gap: float = 1e-3,
                  tol_rp: float = 1e-4, tol_rd: float = 0.05,
                  tol_step: float = 0.0, correctors: int = 0):
    """Solve a batch of factored-row LSC QPs in one fused launch (float32,
    3-D, C <= 64).  ``iters`` is a cap: a QP stops once its gap <
    tol_gap * sigma, primal residual < tol_rp and (dual residual < tol_rd
    or applied step < tol_step) hold on the new iterate; a tolerance of 0
    runs every iteration.  See the module docstring for shapes."""
    if sigma is None:
        sigma = torch.ones(q.shape[0], dtype=q.dtype, device=q.device)
    args = (P_blk, q, y0, U, b_pairs, nsc, scale, b_pl, F_seg, sigma)
    kw = dict(iters=iters, reg=reg, s_min=s_min, tol_gap=tol_gap,
              tol_rp=tol_rp, tol_rd=tol_rd, tol_step=tol_step,
              correctors=correctors)
    if q.device.type == "cuda":
        return _fused_cuda(*args, **kw)
    if q.device.type != "cpu":
        raise RuntimeError(f"ipm_lsc_fused: no kernel for device {q.device}")
    _check(*args)
    return ipm_lsc_fused_plain(*args, **kw)
