"""Batched convex QP solver, primal-dual interior point (port of
lsc_planner_tpu/ops/qp.py: dense rows, factored rows, and the factored
rows' fused single-launch IPM in ``ops/ipm.py``).

    min_y  1/2 y^T P y + q^T y    s.t.  A y >= b          (rows maskable)

Mehrotra predictor-corrector with normal-equations elimination: every
iteration forms H = P + A^T D A, factors it once (``chol.chol_factor_solve``,
a CUDA kernel on the GPU) and re-solves with the kept factor for the
corrector and each Gondzio corrector (``chol.chol_resolve``).

The JAX loop is a ``lax.while_loop``.  Here the loop is a Python loop that
never syncs with the host on the dense path (it has no early exit) and
syncs only every ``EXIT_CHECK_EVERY`` iterations on the factored path; the
per-instance latch freezes finished instances, so iterations run past the
JAX exit point change no iterate, and the reported ``iters`` (the JAX
count) is tracked on the device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import chol, ipm

EXIT_CHECK_EVERY = 8
FUSED_MODES = ("auto", "on", "off")


class QPSolution(NamedTuple):
    y: torch.Tensor           # (..., nv) primal solution
    lam: torch.Tensor         # (..., nr) dual solution
    obj: torch.Tensor         # (...,)   0.5 y'Py + q'y
    primal_res: torch.Tensor  # (...,)   max_i max(b_i - a_i'y, 0)
    gap: torch.Tensor         # (...,)   complementarity mu
    warm_res: Optional[torch.Tensor] = None
    warm_row: Optional[torch.Tensor] = None
    # IPM iterations consumed: () on the _ipm paths, (N,) per-tile counts
    # on the fused path (as the JAX package reports them)
    iters: Optional[torch.Tensor] = None


def _masked(A, b, mask):
    """Zero out masked rows and make their bound trivially satisfied."""
    if mask is None:
        return A, b
    return torch.where(mask[..., None], A, 0.0), torch.where(mask, b, -1.0)


def _equilibrate_rows(A, b, floor: float = 1e-3, bmax: float = 1e3):
    """Unit-norm row equilibration; rows below `floor` go inert and scaled
    bounds are capped at `bmax` (see the JAX package for the rationale)."""
    row_norm = torch.sqrt((A * A).sum(-1))
    dead = row_norm < floor
    scale = 1.0 / torch.clamp(row_norm, min=floor)
    scale = torch.minimum(scale, bmax / torch.clamp(b.abs(), min=1.0))
    A = torch.where(dead[..., None], 0.0, A * scale[..., None])
    b = torch.where(dead, -1.0, b * scale)
    return A, b


def _objective_sigma(P):
    """Per-instance objective scale mean |diag P| (early-exit scaling)."""
    diag = torch.diagonal(P, dim1=-2, dim2=-1)
    return torch.clamp(diag.abs().mean(-1), min=1e-6)


def _matvec(P, y):
    return (P @ y.unsqueeze(-1)).squeeze(-1)


def _step_len(v, dv, tau: float = 0.995):
    """Largest alpha in (0, 1] with v + alpha dv >= (1-tau) v."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0),
                        torch.full_like(v, float("inf")))
    return torch.clamp(tau * ratio.amin(-1), max=1.0)


def _ipm(P, q, mv, rmv, gram, b, y0, iters, reg, s_min,
         tol_gap: float = 0.0, tol_rp: float = 0.0, tol_rd: float = 0.0,
         tol_scale=None, correctors: int = 0, tol_step: float = 0.0):
    """Shared Mehrotra predictor-corrector core (qp.py:135-380).

    mv(y) = A y;  rmv(w) = A^T w;  gram(d) = A^T diag(d) A.  Rows arrive
    pre-equilibrated and pre-masked.  With all of tol_gap, tol_rp, tol_rd
    positive, `iters` is a cap and each instance latches done once its gap,
    primal and (dual residual or step) tests hold."""
    dtype, device = P.dtype, P.device
    nv = P.shape[-1]
    batch = P.shape[:-2]
    tscale = torch.ones(batch, dtype=dtype, device=device) \
        if tol_scale is None else tol_scale
    y = torch.zeros(batch + (nv,), dtype=dtype, device=device) \
        if y0 is None else y0

    s = torch.clamp(mv(y) - b, min=s_min)
    lam = torch.ones_like(s)
    eye = torch.eye(nv, dtype=dtype, device=device)
    exit_on = tol_gap > 0.0 and tol_rp > 0.0 and tol_rd > 0.0
    done_i = torch.zeros(batch, dtype=torch.bool, device=device)
    prev_step = torch.full(batch, float("inf"), dtype=dtype, device=device)
    it_used = torch.full((), iters, dtype=torch.int32, device=device)

    def kkt_rhs(r_d, r_p, r_c):
        return -r_d - rmv((r_c + lam * r_p) / s)

    def kkt_finish(dy, r_p, r_c):
        ds = mv(dy) + r_p
        dlam = -(r_c + lam * ds) / s
        return dy, ds, dlam

    for it in range(iters):
        Ay = mv(y)
        r_d = _matvec(P, y) + q - rmv(lam)
        r_p = Ay - s - b
        mu = (s * lam).mean(-1)
        if exit_on:
            stat = (r_d.abs().amax(-1) < tol_rd) | (prev_step < tol_step)
            inst_done = ((mu < tol_gap * tscale) &
                         (r_p.abs().amax(-1) < tol_rp) & stat)
            done_i = done_i | inst_done
            all_done = done_i.all()
            # the JAX loop stops after the body in which every instance
            # is first done: that body's count is it + 1
            it_used = torch.where(all_done & (it_used == iters),
                                  torch.full_like(it_used, it + 1), it_used)

        D = lam / s
        H = P + gram(D)
        diag_mean = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1) / nv
        ridge = reg * torch.clamp(diag_mean, min=1.0)
        H = H + ridge[..., None, None] * eye
        dsc = torch.rsqrt(torch.diagonal(H, dim1=-2, dim2=-1))
        Hs = H * dsc[..., :, None] * dsc[..., None, :]

        # predictor (affine scaling)
        r_c_aff = s * lam
        rhs_aff = kkt_rhs(r_d, r_p, r_c_aff)
        L, z_aff = chol.chol_factor_solve(Hs, dsc * rhs_aff)
        dy_a, ds_a, dlam_a = kkt_finish(dsc * z_aff, r_p, r_c_aff)
        a_p = _step_len(s, ds_a)
        a_d = _step_len(lam, dlam_a)
        mu_aff = ((s + a_p[..., None] * ds_a) *
                  (lam + a_d[..., None] * dlam_a)).mean(-1)
        sigma = (mu_aff / torch.clamp(mu, min=1e-30)) ** 3

        # corrector
        r_c = s * lam + ds_a * dlam_a - (sigma * mu)[..., None]
        z_c = chol.chol_resolve(L, dsc * kkt_rhs(r_d, r_p, r_c))
        dy, ds, dlam = kkt_finish(dsc * z_c, r_p, r_c)
        a_p = _step_len(s, ds)
        a_d = _step_len(lam, dlam)

        # Gondzio centrality correctors on the same factor
        for _ in range(correctors):
            mu_t = (sigma * mu)[..., None]
            prod = (s + a_p[..., None] * ds) * (lam + a_d[..., None] * dlam)
            target = torch.minimum(torch.maximum(prod, 0.1 * mu_t),
                                   10.0 * mu_t)
            r_cc = r_c + (target - prod)
            z_cc = chol.chol_resolve(L, dsc * kkt_rhs(r_d, r_p, r_cc))
            dy2, ds2, dlam2 = kkt_finish(dsc * z_cc, r_p, r_cc)
            a_p2 = _step_len(s, ds2)
            a_d2 = _step_len(lam, dlam2)
            better_s = a_p2 + a_d2 > a_p + a_d + 0.05
            better = better_s[..., None]
            dy = torch.where(better, dy2, dy)
            ds = torch.where(better, ds2, ds)
            dlam = torch.where(better, dlam2, dlam)
            r_c = torch.where(better, r_cc, r_c)
            a_p = torch.where(better_s, a_p2, a_p)
            a_d = torch.where(better_s, a_d2, a_d)

        y_n = y + a_p[..., None] * dy
        s_n = torch.clamp(s + a_p[..., None] * ds, min=1e-12)
        lam_n = torch.clamp(lam + a_d[..., None] * dlam, min=1e-12)
        # degeneracy guard + convergence latch: such instances keep their
        # previous iterate
        ok = (torch.isfinite(y_n).all(-1) & torch.isfinite(s_n).all(-1) &
              torch.isfinite(lam_n).all(-1) &
              (y_n.abs().amax(-1) < 1e10) & (lam_n.amax(-1) < 1e12))
        ok = ok & ~done_i
        prev_step = torch.where(ok, a_p * dy.abs().amax(-1),
                                torch.zeros_like(a_p))
        y = torch.where(ok[..., None], y_n, y)
        s = torch.where(ok[..., None], s_n, s)
        lam = torch.where(ok[..., None], lam_n, lam)
        if exit_on and (it + 1) % EXIT_CHECK_EVERY == 0 and \
                bool(all_done):
            break

    obj = 0.5 * (y * _matvec(P, y)).sum(-1) + (q * y).sum(-1)
    primal_res = torch.clamp(b - mv(y), min=0.0).amax(-1)
    gap = (s * lam).mean(-1)
    return QPSolution(y=y, lam=lam, obj=obj, primal_res=primal_res, gap=gap,
                      iters=it_used)


def solve_qp(P, q, A, b, mask=None, y0=None, iters: int = 20,
             reg: float = 1e-8, s_min: float = 1.0, equilibrate: bool = True,
             correctors: int = 0) -> QPSolution:
    """Batched inequality-form QP over dense rows (no early exit).  With a
    warm start y0 the solve runs in delta coordinates d = y - y0."""
    A, b = _masked(A, b, mask)
    if equilibrate:
        A, b = _equilibrate_rows(A, b)

    def mv(y):
        return (A @ y.unsqueeze(-1)).squeeze(-1)

    def rmv(w):
        return (A.mT @ w.unsqueeze(-1)).squeeze(-1)

    def gram(d):
        return A.mT @ (A * d[..., None])

    if y0 is not None:
        sol = _ipm(P, q + _matvec(P, y0), mv, rmv, gram, b - mv(y0), None,
                   iters, reg, s_min, correctors=correctors)
        y = y0 + sol.y
        obj = 0.5 * (y * _matvec(P, y)).sum(-1) + (q * y).sum(-1)
        return sol._replace(y=y, obj=obj)
    return _ipm(P, q, mv, rmv, gram, b, None, iters, reg, s_min,
                correctors=correctors)


def solve_qp_lsc(P, q, A_st, b_st, normal, rhs, mask, F_seg, y0=None,
                 iters: int = 20, reg: float = 1e-8, s_min: float = 1.0,
                 static_blocks=None, P_blk=None, fused_mode: str = "off",
                 tol_gap: float = 1e-3, tol_rp: float = 1e-4,
                 tol_rd: float = 0.05, tol_step: float = 0.0,
                 correctors: int = 0) -> QPSolution:
    """Factored-row QP solve (qp.py:431-659).

    Static rows A_st (R_s, nv) are agent-shared with per-agent rhs b_st
    (N, R_s); every plane row is normal_{c,m} (x) F_seg[m, i, :] over the
    dim-major layout y = (kdim, nf).  normal: (N, C, M, kdim); rhs/mask:
    (N, C, M, n+1); F_seg: (M, n+1, nf).  static_blocks = (U, row_perm,
    inv_row_perm) from TrajOptimizer.static_blocked enables the blocked
    static Gram.  Duals come back as [static rows, plane rows (c-major)].

    With static_blocks and P_blk given, fused_mode picks the single-launch
    IPM (``ipm.ipm_lsc_fused``, qp.py:618-648): "auto" on CUDA in float32,
    "on" on any device (a CPU tensor runs its plain version; the tests'
    counterpart of the JAX package's "interpret"), "off" never.  The fused
    IPM is float32 only and raises for any other dtype."""
    if fused_mode not in FUSED_MODES:
        raise ValueError(f"fused_mode {fused_mode!r} not in {FUSED_MODES}")
    dtype, device = P.dtype, P.device
    N = P.shape[0]
    M, n1, nf = F_seg.shape
    C = normal.shape[1]
    nv = P.shape[-1]

    sigma = _objective_sigma(P)
    F_seg = torch.as_tensor(F_seg, dtype=dtype, device=device)
    A_st = torch.as_tensor(A_st, dtype=dtype, device=device)

    # static rows: equilibrate once, pair-symmetric bound cap
    st_norm = torch.sqrt((A_st * A_st).sum(-1) + 1e-12)
    st_dead = st_norm < 1e-3
    st_scale = 1.0 / torch.clamp(st_norm, min=1e-3)
    b_absmax = b_st.abs().amax(0)
    b_absmax = torch.repeat_interleave(
        b_absmax.reshape(-1, 2).amax(1), 2)
    st_scale = torch.minimum(st_scale,
                             1e3 / torch.clamp(b_absmax, min=1.0))
    st_scale = torch.where(st_dead, 0.0, st_scale)
    A_st = A_st * st_scale[:, None]
    b_st = torch.where(st_dead[None, :], -1.0, b_st * st_scale[None, :])

    if static_blocks is not None:
        U_np, row_perm_np, inv_row_perm_np = static_blocks
        ndim, Ru = U_np.shape[0], U_np.shape[1]
        row_perm = torch.as_tensor(row_perm_np, device=device)
        inv_row_perm = torch.as_tensor(inv_row_perm_np, device=device)
        u_scale = st_scale[row_perm[0::2]]
        U = torch.as_tensor(U_np, dtype=dtype, device=device) * \
            u_scale.reshape(ndim, Ru)[..., None]

    # plane rows: |a_{c,m,i}| = |n_{c,m}| |F_seg[m,i]|
    f_norm = torch.sqrt((F_seg * F_seg).sum(-1))                # (M, n+1)
    n_norm = torch.sqrt((normal * normal).sum(-1))              # (N, C, M)
    row_norm = n_norm[..., None] * f_norm[None, None]
    rhs_d = rhs.to(dtype)
    scale = 1.0 / torch.clamp(row_norm, min=1e-3)
    scale = torch.minimum(scale, 1e3 / torch.clamp(rhs_d.abs(), min=1.0))
    live = mask & (row_norm >= 1e-3)
    scale = torch.where(live, scale, 0.0)
    b_pl = torch.where(live, rhs_d * scale, -1.0)

    nsc = normal.to(dtype)
    kdim = normal.shape[-1]
    R_s = A_st.shape[0]

    def mv_st(y):
        if static_blocks is None:
            return y @ A_st.T
        s_u = torch.einsum("kuf,nkf->nku", U, y.reshape(N, ndim, nf))
        pair = torch.stack([s_u, -s_u], dim=-1)
        return pair.reshape(N, R_s)[:, inv_row_perm]

    def rmv_st(w_st):
        if static_blocks is None:
            return w_st @ A_st
        w_p = w_st[:, row_perm].reshape(N, ndim, Ru, 2)
        w_pair = w_p[..., 0] - w_p[..., 1]
        return torch.einsum("kuf,nku->nkf", U, w_pair).reshape(N, nv)

    FF = torch.einsum("mif,mig->mifg", F_seg, F_seg)
    eye_k = torch.eye(kdim, dtype=dtype, device=device)

    def mv(y):
        x = torch.einsum("mif,nkf->nkmi", F_seg, y.reshape(N, kdim, nf))
        pl = torch.einsum("ncmk,nkmi->ncmi", nsc, x) * scale
        return torch.cat([mv_st(y), pl.reshape(N, -1)], dim=1)

    def rmv(w):
        w_pl = w[:, R_s:].reshape(N, C, M, n1) * scale
        v = torch.einsum("ncmi,ncmk->nkmi", w_pl, nsc)
        r_pl = torch.einsum("mif,nkmi->nkf", F_seg, v).reshape(N, nv)
        return rmv_st(w[:, :R_s]) + r_pl

    def gram(d):
        d_pl = d[:, R_s:].reshape(N, C, M, n1) * scale * scale
        W = torch.einsum("ncmi,ncmk,ncml->nklmi", d_pl, nsc, nsc)
        H_pl = torch.einsum("nklmi,mifg->nkflg", W, FF)
        if static_blocks is None:
            H_st = torch.einsum("rv,nr,rw->nvw", A_st, d[:, :R_s], A_st)
            return H_st + H_pl.reshape(N, nv, nv)
        d_p = d[:, :R_s][:, row_perm].reshape(N, ndim, Ru, 2)
        d_pair = d_p[..., 0] + d_p[..., 1]
        H_blk = torch.einsum("kuf,nku,kug->nkfg", U, d_pair, U)
        H_pl = H_pl + torch.einsum("nkfg,kl->nkflg", H_blk, eye_k)
        return H_pl.reshape(N, nv, nv)

    q_orig = q
    if y0 is not None:
        # delta reformulation around the warm start (qp.py:583-603)
        ay0 = mv(y0)
        b_st = b_st - ay0[:, :R_s]
        pl0 = ay0[:, R_s:].reshape(N, C, M, n1)
        b_pl = torch.where(live, b_pl - pl0, -1.0)
        q = q + _matvec(P, y0)
    b = torch.cat([b_st, b_pl.reshape(N, C * M * n1)], dim=1)

    if y0 is not None:
        # the warm point is d = 0, so its violation is b itself
        warm_res, warm_row = b.max(-1)
    else:
        warm_res = warm_row = None

    use_fused = (static_blocks is not None and P_blk is not None and
                 (fused_mode == "on" or
                  (fused_mode == "auto" and device.type == "cuda" and
                   dtype == torch.float32)))
    if use_fused:
        bp = b_st[:, row_perm]                           # pair-major
        b_pairs = torch.stack([bp[:, 0::2], bp[:, 1::2]], dim=1)
        P_blk = P_blk.to(dtype)
        d, lam_s, lam_p, gap, it_used = ipm.ipm_lsc_fused(
            P_blk, q, torch.zeros((N, nv), dtype=dtype, device=device), U,
            b_pairs, nsc, scale, b_pl, F_seg, sigma, iters=iters, reg=reg,
            s_min=s_min, tol_gap=tol_gap, tol_rp=tol_rp, tol_rd=tol_rd,
            tol_step=tol_step, correctors=correctors)
        primal_res = torch.clamp(b - mv(d), min=0.0).amax(-1)
        y = d if y0 is None else y0 + d
        # duals back to [static original order, plane rows]
        lam_perm = torch.stack([lam_s[:, 0], lam_s[:, 1]],
                               dim=-1).reshape(N, R_s)
        lam = torch.cat([lam_perm[:, inv_row_perm], lam_p], dim=1)
        y3 = y.reshape(N, kdim, nf)
        obj = 0.5 * torch.einsum("nkf,nfg,nkg->n", y3, P_blk, y3) + \
            (q_orig * y).sum(-1)
        return QPSolution(y=y, lam=lam, obj=obj, primal_res=primal_res,
                          gap=gap, warm_res=warm_res, warm_row=warm_row,
                          iters=it_used)

    sol = _ipm(P, q, mv, rmv, gram, b, None, iters, reg, s_min,
               tol_gap=tol_gap, tol_rp=tol_rp, tol_rd=tol_rd,
               tol_scale=sigma, correctors=correctors, tol_step=tol_step)
    if y0 is not None:
        y = y0 + sol.y
        obj = 0.5 * (y * _matvec(P, y)).sum(-1) + (q_orig * y).sum(-1)
        sol = sol._replace(y=y, obj=obj)
    return sol._replace(warm_res=warm_res, warm_row=warm_row)


def violation_report(A, b, y, mask=None, top_k: int = 5):
    """Per-row violations of A y >= b at y, largest first: (values, rows)."""
    A, b = _masked(A, b, mask)
    viol = b - (A @ y.unsqueeze(-1)).squeeze(-1)
    return torch.topk(viol, top_k, dim=-1)
