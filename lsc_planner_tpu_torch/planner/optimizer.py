"""Trajectory-QP assembly: batched min-jerk Bernstein optimization (port
of lsc_planner_tpu/planner/optimizer.py).

The equality constraints (initial-state pin, C^{phi-1} continuity, the
LSC stop-at-horizon rows) are eliminated at setup, x = F y + G s0, and the
cost and every inequality row are assembled as fixed-shape batched tensors
for the interior-point solver in ``ops/qp.py``.  A 2-D world drops the z
block (nv = 2 nf; z is the held particular solution), and a slack-relaxed
QP (``SlackSpec``) goes through dense rows with one slack column an
(obstacle, segment) or two a segment for the dynamical limits.  The
static tables are the JAX package's float64 numpy code, copied (the JAX
module imports jax); a test holds them equal to the JAX tables.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import trace
from ..config import Param, PlannerMode, SP_EPSILON
from ..ops import bernstein as bz
from ..ops import qp as qp_ops


class PlaneConstraints(NamedTuple):
    """Half-space rows per control point: normal . x_{m,i} >= rhs_{m,i}.
    normal (N, C, M, 3); rhs (N, C, M, n+1); mask (N, C, M)."""
    normal: torch.Tensor
    rhs: torch.Tensor
    mask: torch.Tensor


class SlackSpec(NamedTuple):
    """Slack-variable relaxation (traj_optimizer.cpp:306-326, :374-390).
    mode "collision": one slack a (constraint entry c < n_slack_c, segment
    m) on that obstacle's LSC rows, where enable (N, C) marks it;
    "dynamical": 2 M slacks on every agent's velocity (m) and acceleration
    (M + m) rows."""
    mode: str
    enable: Optional[torch.Tensor] = None
    n_slack_c: int = 0
    weight: float = 100000.0


class QPResult(NamedTuple):
    traj: torch.Tensor        # (N, M, n+1, 3)
    cost: torch.Tensor        # (N,)
    primal_res: torch.Tensor  # (N,) max constraint violation of the solution
    gap: torch.Tensor         # (N,) complementarity
    y: torch.Tensor           # (N, nv) raw solution (warm-start handle)
    slack: Optional[torch.Tensor] = None
    warm_res: Optional[torch.Tensor] = None
    warm_row: Optional[torch.Tensor] = None
    lam: Optional[torch.Tensor] = None
    iters: Optional[torch.Tensor] = None


def _build_equality_basis(M: int, n: int, phi: int, dt: float,
                          stop_at_horizon: bool):
    """Return (F, G, free_cols) with x_dim = F @ y_dim + G @ [p0, v0, a0]
    (buildAeqBase, traj_optimizer.cpp:186-236)."""
    nv = M * (n + 1)

    def col(m, i):
        return m * (n + 1) + i

    A0 = np.zeros((phi, n + 1))
    AT = np.zeros((phi, n + 1))
    for j in range(phi):
        for t in range(j + 1):
            A0[j, t] = (-1.0) ** (j - t) * bz.nchoosek(j, t)
            AT[j, n - t] = (-1.0) ** t * bz.nchoosek(j, t)

    n_eq = phi + (M - 1) * phi
    E = np.zeros((n_eq, nv))
    for j in range(phi):
        fall = 1.0
        for t in range(j):
            fall *= (n - t)
        E[j, col(0, 0):col(0, n + 1)] = dt ** (-j) * fall * A0[j]
    for m in range(1, M):
        for j in range(phi):
            fall = 1.0
            for t in range(j):
                fall *= (n - t)
            r = phi + (m - 1) * phi + j
            E[r, col(m - 1, 0):col(m - 1, n + 1)] = dt ** (-j) * fall * AT[j]
            E[r, col(m, 0):col(m, n + 1)] = -(dt ** (-j)) * fall * A0[j]

    det_cols = [col(m, i) for m in range(M) for i in range(phi)]
    free_cols = [col(m, i) for m in range(M) for i in range(phi, n + 1)]
    Edd = E[:, det_cols]
    Edf = E[:, free_cols]
    Edd_inv = np.linalg.inv(Edd)

    nf = len(free_cols)
    F = np.zeros((nv, nf))
    G = np.zeros((nv, phi))
    F[det_cols, :] = -Edd_inv @ Edf
    for k, c in enumerate(free_cols):
        F[c, k] = 1.0
    G[det_cols, :] = Edd_inv[:, :phi]

    if stop_at_horizon:
        # c[M-1][n] == c[M-1][n-i], i = 1..phi-1 (traj_optimizer.cpp:529-536)
        n_free_seg = n + 1 - phi
        keep = nf - n_free_seg
        n_untied = n + 1 - 2 * phi
        if n_untied < 0:
            raise NotImplementedError("stop-at-horizon needs n >= 2*phi-1")
        nf_red = keep + n_untied + 1
        R = np.zeros((nf, nf_red))
        for k in range(keep + n_untied):
            R[k, k] = 1.0
        for k in range(keep + n_untied, nf):
            R[k, nf_red - 1] = 1.0
        F = F @ R

    return F, G, free_cols


@dataclasses.dataclass
class TrajOptimizer:
    """Static QP structure for a given Param; tensors of the tables are
    cached per (dtype, device)."""
    param: Param

    def __post_init__(self):
        if self.param.qp_fused_mode not in qp_ops.FUSED_MODES:
            raise ValueError(f"qp_fused_mode {self.param.qp_fused_mode!r} "
                             f"not in {qp_ops.FUSED_MODES}")
        self._cache = {}

    def _t(self, name: str, dtype, device, index=None) -> torch.Tensor:
        """The table `name` (its entry `index` when it is a tuple) as a
        tensor on the device, made once: no cycle copies it from the
        host."""
        key = (name, index, dtype, device)
        if key not in self._cache:
            a = getattr(self, name)
            self._cache[key] = torch.as_tensor(
                a if index is None else a[index], dtype=dtype, device=device)
        return self._cache[key]

    @cached_property
    def M(self):
        return self.param.M

    @cached_property
    def n(self):
        return self.param.n

    @cached_property
    def dim(self):
        """QP dimensions: a 2-D world drops the z block (every `dim == 3`
        of traj_optimizer.cpp:261-539); its z trajectory is the equality
        particular solution held at z0."""
        return 2 if self.param.world_dimension == 2 else 3

    @cached_property
    def _FG(self):
        stop = self.param.planner_mode == PlannerMode.LSC
        return _build_equality_basis(self.M, self.n, self.param.phi,
                                     self.param.dt, stop)

    @property
    def F(self) -> np.ndarray:
        return self._FG[0]

    @property
    def G(self) -> np.ndarray:
        return self._FG[1]

    @cached_property
    def nf(self) -> int:
        return self.F.shape[1]

    @cached_property
    def nv(self) -> int:
        return self.dim * self.nf

    @cached_property
    def Q_full(self) -> np.ndarray:
        """Block-diagonal per-segment jerk Gram, (M(n+1), M(n+1))."""
        Qb = bz.q_base(self.n, self.param.phi, self.param.phi_n,
                       self.param.dt)
        return np.kron(np.eye(self.M), Qb)

    @cached_property
    def FQF(self) -> np.ndarray:
        return self.F.T @ self.Q_full @ self.F

    @cached_property
    def FQ(self) -> np.ndarray:
        return self.F.T @ self.Q_full

    @cached_property
    def endpoint_rows(self) -> np.ndarray:
        """U[m] = F[(m, n), :] -- y-space row of each segment endpoint."""
        idx = [m * (self.n + 1) + self.n for m in range(self.M)]
        return self.F[idx, :]

    @cached_property
    def F_seg(self) -> np.ndarray:
        return self.F.reshape(self.M, self.n + 1, self.nf)

    @cached_property
    def y_extract_idx(self) -> np.ndarray:
        """x-space index of the control point each reduced free variable
        parameterizes, searched among the free x-columns only (see the JAX
        package for the C^2 row that a full scan would pick wrongly)."""
        free = np.asarray(self._FG[2])
        idx = []
        for k in range(self.nf):
            rows = np.nonzero(np.abs(self.F[free, k] - 1.0) < 1e-12)[0]
            idx.append(int(free[rows[-1]]))
        return np.asarray(idx)

    def extract_y(self, traj):
        """Trajectories (N, M, n+1, 3) -> warm-start vectors (N, nv)."""
        N = traj.shape[0]
        x = traj.permute(0, 3, 1, 2)[:, :self.dim].reshape(
            N, self.dim, self.M * (self.n + 1))
        idx = self._t("y_extract_idx", torch.int64, traj.device)
        return x[:, :, idx].reshape(N, self.nv)

    # ------------------------------------------------------------------
    # static inequality rows (world bounds, velocity, acceleration)
    # ------------------------------------------------------------------
    @cached_property
    def static_rows(self):
        """(A_x (R, dim, nvx), kinds) (traj_optimizer.cpp:274-303,
        :472-523)."""
        M, n, phi, dim = self.M, self.n, self.param.phi, self.dim
        dt = self.param.dt
        nvx = M * (n + 1)
        rows = []

        def col(m, i):
            return m * (n + 1) + i

        for k in range(dim):
            for m in range(M):
                for i in range(n + 1):
                    if m == 0 and i < phi:
                        continue
                    a = np.zeros((dim, nvx))
                    a[k, col(m, i)] = 1.0
                    rows.append((a, "lb", k, m))
                    rows.append((-a, "ub", k, m))
        for k in range(dim):
            for m in range(M):
                for i in range(n):
                    if m == 0 and i in (0, 1):
                        continue
                    a = np.zeros((dim, nvx))
                    a[k, col(m, i + 1)] = n / dt
                    a[k, col(m, i)] = -n / dt
                    rows.append((-a, "vel", k, m))
                    rows.append((a, "vel", k, m))
        for k in range(dim):
            for m in range(M):
                for i in range(n - 1):
                    if m == 0 and i == 0:
                        continue
                    a = np.zeros((dim, nvx))
                    c2 = n * (n - 1) / dt ** 2
                    a[k, col(m, i + 2)] = c2
                    a[k, col(m, i + 1)] = -2 * c2
                    a[k, col(m, i)] = c2
                    rows.append((-a, "acc", k, m))
                    rows.append((a, "acc", k, m))

        A_x = np.stack([r[0] for r in rows])
        kinds = [(r[1], r[2], r[3]) for r in rows]
        return A_x, kinds

    @cached_property
    def A_x(self) -> np.ndarray:
        return self.static_rows[0]

    @cached_property
    def A_static_y(self) -> np.ndarray:
        """Static rows mapped to y-space, (R_s, nv)."""
        A_x, _ = self.static_rows
        Ay = np.einsum("rkp,pf->rkf", A_x, self.F)
        return Ay.reshape(A_x.shape[0], self.nv)

    @cached_property
    def static_blocked(self):
        """(U (dim, Ru, nf), row_perm, inv_row_perm): the one-block-per-row,
        +- paired structure of the static rows (blocked static Gram)."""
        A = self.A_static_y
        nf = self.nf
        R_s = A.shape[0]
        _, kinds = self.static_rows
        dim_of = np.asarray([k for _kind, k, _m in kinds])
        if not (np.all(dim_of[0::2] == dim_of[1::2]) and
                all(np.allclose(A[2 * p], -A[2 * p + 1])
                    for p in range(R_s // 2))):
            raise ValueError("static rows are not +- pairs within a dim")
        pair_perm = np.argsort(dim_of[0::2], kind="stable")
        row_perm = np.empty(R_s, np.int64)
        row_perm[0::2] = 2 * pair_perm
        row_perm[1::2] = 2 * pair_perm + 1
        inv_row_perm = np.argsort(row_perm)
        counts = np.bincount(dim_of[0::2], minlength=self.dim)
        if not np.all(counts == counts[0]):
            raise ValueError("unequal static rows per dim")
        Ru = int(counts[0])
        U = np.zeros((self.dim, Ru, nf))
        for k in range(self.dim):
            rows = 2 * pair_perm[k * Ru:(k + 1) * Ru]
            U[k] = A[rows][:, k * nf:(k + 1) * nf]
        return U, row_perm, inv_row_perm

    @cached_property
    def _static_b_index(self):
        """(kind_id, k_idx) per static row; kind_id 0=lb 1=ub 2=vel 3=acc."""
        _, kinds = self.static_rows
        kind_id = np.asarray([{"lb": 0, "ub": 1, "vel": 2, "acc": 3}[kd]
                              for kd, _k, _m in kinds], np.int64)
        k_idx = np.asarray([k for _kd, k, _m in kinds], np.int64)
        return kind_id, k_idx

    def static_blocked_on(self, dtype, device):
        """static_blocked as tensors on the device (U in dtype, the row
        permutations int64), made once."""
        return tuple(self._t("static_blocked", dt, device, k)
                     for k, dt in enumerate((dtype, torch.int64,
                                             torch.int64)))

    def static_b(self, world_min, world_max, max_vel, max_acc, gx):
        """Per-agent rhs of the static rows, (N, R_s); gx (N, dim, nvx) is
        the G @ s0 contribution."""
        A_x = self._t("A_x", gx.dtype, gx.device)
        kind_id = self._t("_static_b_index", torch.int64, gx.device, 0)
        k_idx = self._t("_static_b_index", torch.int64, gx.device, 1)
        bound_r = torch.where(kind_id == 0, world_min[k_idx],
                              -world_max[k_idx])
        limit_r = torch.where((kind_id == 2)[None, :], -max_vel[:, k_idx],
                              -max_acc[:, k_idx])
        b0 = torch.where((kind_id < 2)[None, :], bound_r[None, :], limit_r)
        return b0 - torch.einsum("rkp,nkp->nr", A_x, gx)

    # ------------------------------------------------------------------
    # per-cycle assembly + solve
    # ------------------------------------------------------------------
    def solve(self, pos, vel, acc, current_goal, nominal_velocity,
              max_vel, max_acc, planes: PlaneConstraints, world_min,
              world_max, y_warm: Optional[torch.Tensor] = None,
              slack=None, dtype=torch.float32) -> QPResult:
        """Assemble and solve the swarm QP; pos/vel/acc/current_goal,
        max_vel/max_acc (N, 3); slack a SlackSpec or None.  Returns batched
        trajectories."""
        p = self.param
        N = pos.shape[0]
        dev = pos.device
        M, n, phi, dim = self.M, self.n, p.phi, self.dim
        nf, nv = self.nf, self.nv

        FQF = self._t("FQF", dtype, dev)
        FQ = self._t("FQ", dtype, dev)
        U = self._t("endpoint_rows", dtype, dev)        # (M, nf)
        G = self._t("G", dtype, dev)                    # (nvx, phi)
        F_seg = self._t("F_seg", dtype, dev)            # (M, n+1, nf)

        s0 = torch.stack([pos, vel, acc], dim=1).transpose(1, 2)  # (N,3,phi)
        gx3 = torch.einsum("pj,nkj->nkp", G, s0)        # (N, 3, nvx)
        g_seg3 = gx3.reshape(N, 3, M, n + 1)
        gx = gx3[:, :dim]
        g_seg = g_seg3[:, :dim]

        # terminal weight mask (getTerminalSegments, :541-548)
        dist_to_goal = torch.linalg.vector_norm(current_goal - pos, dim=-1)
        ideal_time = dist_to_goal / torch.clamp(nominal_velocity, min=1e-6)
        T = torch.clamp(torch.floor((M * p.dt - ideal_time + SP_EPSILON) /
                                    p.dt), min=1.0)
        T = torch.clamp(T, 1.0, M).to(torch.int32)
        m_idx = torch.arange(M, device=dev)
        tmask = (m_idx[None, :] >= (M - T)[:, None]).to(dtype)   # (N, M)

        # cost: P block-diagonal with equal (nf, nf) blocks, q (N, nv)
        w_ci = p.control_input_weight
        w_t = self._terminal_weight(dist_to_goal, dtype)
        P_ci = 2.0 * w_ci * FQF
        P_term = 2.0 * w_t[:, None, None] * \
            torch.einsum("nm,mf,mg->nfg", tmask, U, U)
        P_blk = P_ci[None] + P_term                              # (N,nf,nf)
        g_end = g_seg[..., :, n]                                 # (N,dim,M)
        q_ci = 2.0 * w_ci * torch.einsum("fp,nkp->nkf", FQ, gx)
        q_term = 2.0 * w_t[:, None, None] * torch.einsum(
            "nm,mf,nkm->nkf", tmask, U,
            g_end - current_goal[:, :dim, None])
        q = (q_ci + q_term).reshape(N, nv)
        P = torch.zeros((N, nv, nv), dtype=dtype, device=dev)
        for k in range(dim):
            P[:, k * nf:(k + 1) * nf, k * nf:(k + 1) * nf] = P_blk

        # plane (LSC) rows: the rhs takes the full 3-D particular solution
        # (in 2-D the held z folds n_z z into b), the rows the QP dims only
        normal3, rhs, cmask = planes.normal.to(dtype), planes.rhs, planes.mask
        C = normal3.shape[1]
        b_pl4 = rhs.to(dtype) - torch.einsum("ncmk,nkmi->ncmi", normal3,
                                             g_seg3)
        normal = normal3[..., :dim]
        i_idx = torch.arange(n + 1, device=dev)
        iskip = (m_idx[:, None] > 0) | (i_idx[None, :] >= phi)   # (M, n+1)
        ncs_mask = m_idx < p.n_constraint_segments
        mask_pl4 = (cmask[..., None] & iskip[None, None] &
                    ncs_mask[None, None, :, None])

        b_st = self.static_b(torch.as_tensor(world_min, dtype=dtype,
                                             device=dev),
                             torch.as_tensor(world_max, dtype=dtype,
                                             device=dev),
                             max_vel.to(dtype), max_acc.to(dtype), gx)

        # row-representation dispatch (optimizer.py:541-578): dense rows
        # while the (N, C*M*(n+1), nv) row tensor stays under 48 MiB,
        # factored rows above, and on CUDA in float32 at N >=
        # qp_fused_min_agents ("tpu" read as "cuda") the fused
        # single-launch IPM kernel
        dense_bytes = N * C * M * (n + 1) * nv * \
            torch.finfo(dtype).bits // 8
        fused_ok = (dev.type == "cuda" and dtype == torch.float32 and
                    (p.qp_fused_mode == "on" or
                     (p.qp_fused_mode == "auto" and
                      N >= p.qp_fused_min_agents)))
        if slack is None and (dense_bytes > 48 * 2 ** 20 or fused_ok):
            trace.mark("ipm")
            sol = qp_ops.solve_qp_lsc(
                P, q, self._t("A_static_y", dtype, dev), b_st, normal,
                b_pl4, mask_pl4, F_seg, y0=y_warm, iters=p.qp_iterations,
                tol_gap=p.qp_tol_gap, tol_rp=p.qp_tol_rp,
                tol_rd=p.qp_tol_rd, tol_step=p.qp_tol_step,
                correctors=p.qp_correctors, s_min=p.qp_s_min,
                static_blocks=self.static_blocked_on(dtype, dev),
                P_blk=P_blk,
                fused_mode=(p.qp_fused_mode if fused_ok else "off"))
            return self._recover(sol, N, dtype, tmask, current_goal, gx3)

        # dense rows (always for a slack-relaxed QP)
        A_pl = torch.einsum("ncmk,mif->ncmikf", normal, F_seg).reshape(
            N, C * M * (n + 1), nv)
        A_st = self._t("A_static_y", dtype, dev)
        A = torch.cat([A_st.expand(N, *A_st.shape), A_pl], dim=1)
        b = torch.cat([b_st, b_pl4.reshape(N, -1)], dim=1)
        mask = torch.cat([torch.ones(b_st.shape, dtype=torch.bool,
                                     device=dev),
                          mask_pl4.reshape(N, -1)], dim=1)
        slack_w = None
        if slack is not None:
            # one column a slack, -1 on its rows, and the bound rows
            # -s >= 0 (optimizer.py:594-637)
            S, onehot, c_of_row, slack_w = self._slack_layout(
                slack, b_st.shape[1], C, dtype, dev)
            R = A.shape[1]
            if slack.mode == "collision":
                en = slack.enable.to(dtype)
                en = torch.where(c_of_row[None, :] >= 0,
                                 en[:, c_of_row.clamp(min=0)], 0.0)
                A_sl = -onehot[None] * en[..., None]
            else:
                A_sl = -onehot[None].expand(N, R, S)
            eyeS = torch.eye(S, dtype=dtype, device=dev)
            bound_rows = torch.cat(
                [torch.zeros((N, S, nv), dtype=dtype, device=dev),
                 -eyeS[None].expand(N, S, S)], dim=2)
            A = torch.cat([torch.cat([A, A_sl], dim=2), bound_rows], dim=1)
            b = torch.cat([b, torch.zeros((N, S), dtype=dtype, device=dev)],
                          dim=1)
            mask = torch.cat([mask, torch.ones((N, S), dtype=torch.bool,
                                               device=dev)], dim=1)
            P_ext = torch.zeros((N, nv + S, nv + S), dtype=dtype, device=dev)
            P_ext[:, :nv, :nv] = P
            P_ext[:, nv:, nv:] = torch.diag(slack_w)
            P = P_ext
            q = torch.cat([q, torch.zeros((N, S), dtype=dtype, device=dev)],
                          dim=1)
            if y_warm is not None:
                y_warm = torch.cat(
                    [y_warm, torch.zeros((N, S), dtype=dtype, device=dev)],
                    dim=1)
        trace.mark("ipm")
        sol = qp_ops.solve_qp(P, q, A, b, mask=mask, y0=y_warm,
                              iters=p.qp_iterations, s_min=p.qp_s_min,
                              correctors=p.qp_correctors,
                              count_tol=(p.qp_tol_gap, p.qp_tol_rp,
                                         p.qp_tol_rd, p.qp_tol_step))
        return self._recover(sol, N, dtype, tmask, current_goal, gx3,
                             slack_w)

    def _slack_layout(self, slack: SlackSpec, n_rows_static: int, C: int,
                      dtype, device):
        """(S, one-hot (R, S) of each row's slack column (a zero row for
        none), each row's constraint entry (R,) int64 (-1 for static rows
        and for entries past n_slack_c; "collision" only, else None), the
        slack weights (S,)), made once a layout, dtype and device
        (optimizer.py:437-460)."""
        key = ("slack", slack.mode, slack.n_slack_c, slack.weight,
               n_rows_static, C, dtype, device)
        if key not in self._cache:
            M, n = self.M, self.n
            if slack.mode == "collision":
                S = slack.n_slack_c * M
                col_static = np.full(n_rows_static, -1)
                cmi = np.full((C, M, n + 1), -1)
                for c in range(min(slack.n_slack_c, C)):
                    for m in range(M):
                        cmi[c, m, :] = c * M + m
                col_planes = cmi.reshape(-1)
                m_of = np.tile(np.arange(M), slack.n_slack_c)
                c_rows = np.repeat(np.arange(C), M * (n + 1))
                c_rows[c_rows >= slack.n_slack_c] = -1
                c_of_row = torch.as_tensor(np.concatenate(
                    [np.full(n_rows_static, -1), c_rows]), device=device)
            elif slack.mode == "dynamical":
                S = 2 * M
                _, kinds = self.static_rows
                col_static = np.asarray(
                    [m if kind == "vel" else (M + m if kind == "acc" else -1)
                     for kind, _k, m in kinds])
                col_planes = np.full(C * M * (n + 1), -1)
                m_of = np.concatenate([np.arange(M), np.arange(M)])
                c_of_row = None
            else:
                raise ValueError(f"slack mode {slack.mode!r} not in "
                                 "('collision', 'dynamical')")
            col = np.concatenate([col_static, col_planes])
            onehot = (col[:, None] == np.arange(S)[None, :])
            weights = 2.0 * slack.weight * (M - m_of) / M
            self._cache[key] = (
                S, torch.as_tensor(onehot, dtype=dtype, device=device),
                c_of_row, torch.as_tensor(weights, dtype=dtype,
                                          device=device))
        return self._cache[key]

    def _terminal_weight(self, dist_to_goal, dtype):
        """Per-agent terminal weight: "distance" mode clamps w / dist into
        [w, 10 w]; "simple" mode is the constant w."""
        p = self.param
        if p.terminal_weight_mode == "distance":
            w = torch.clamp(p.terminal_weight /
                            torch.clamp(dist_to_goal, min=1e-3),
                            p.terminal_weight, 10.0 * p.terminal_weight)
            return w.to(dtype)
        return torch.full(dist_to_goal.shape, p.terminal_weight,
                          dtype=dtype, device=dist_to_goal.device)

    def _recover(self, sol, N, dtype, tmask, current_goal, gx3,
                 slack_w=None):
        """QP solution -> control points and the CPLEX-parity objective
        (plus 0.5 w s^2 of the slacks, slack_w their weights).  In 2-D the
        z trajectory is the hold at z0: gx3's z row with the free part
        pinned at z0 (optimizer.py:680-690)."""
        M, n, dim = self.M, self.n, self.dim
        nf, nv = self.nf, self.nv
        dev = gx3.device
        F = self._t("F", dtype, dev)
        y_sol = sol.y[:, :nv]
        x = torch.einsum("pf,nkf->nkp", F, y_sol.reshape(N, dim, nf)) + \
            gx3[:, :dim]
        if dim < 3:
            z0 = gx3[:, 2, 0]
            z_row = z0[:, None] * F.sum(1)[None, :] + gx3[:, 2]
            x3 = torch.cat([x, z_row[:, None, :]], dim=1)
        else:
            x3 = x
        traj = x3.reshape(N, 3, M, n + 1).permute(0, 2, 3, 1).contiguous()

        Qf = self._t("Q_full", dtype, dev)
        cost_ci = self.param.control_input_weight * torch.einsum(
            "nkp,pq,nkq->n", x, Qf, x)
        endpoints = traj[:, :, n, :dim]
        pos0 = traj[:, 0, 0, :]
        w_t = self._terminal_weight(
            torch.linalg.vector_norm(current_goal - pos0, dim=-1), dtype)
        cost_term = w_t * torch.einsum(
            "nm,nmk->n", tmask,
            (endpoints - current_goal[:, None, :dim]) ** 2)
        cost = cost_ci + cost_term
        slack_vals = None
        if slack_w is not None:
            slack_vals = sol.y[:, nv:]
            cost = cost + 0.5 * (slack_w * slack_vals ** 2).sum(-1)
        return QPResult(traj=traj, cost=cost, primal_res=sol.primal_res,
                        gap=sol.gap, y=y_sol, slack=slack_vals,
                        warm_res=sol.warm_res, warm_row=sol.warm_row,
                        lam=sol.lam, iters=sol.iters)
