"""Bernstein-polynomial algebra (port of lsc_planner_tpu/ops/bernstein.py).

The static matrices (basis change, jerk Gram, subdivision) are float64
numpy built once, as in the JAX package; curve evaluation and the
flat-output state run on tensors with any leading batch dims.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

GRAVITY = 9.81


def nchoosek(n: int, k: int) -> int:
    if k < 0 or k > n:
        return 0
    return math.comb(n, k)


def coef_derivative(i: int, k: int) -> int:
    """Falling factorial i*(i-1)*...*(i-k+1); 0 when i < k."""
    if i < k:
        return 0
    c = 1
    for j in range(k):
        c *= i - j
    return c


@lru_cache(maxsize=None)
def bernstein_matrix(n: int) -> np.ndarray:
    """Bernstein->monomial basis change B (n+1, n+1): for control points c
    the monomial coefficients of the curve are B^T c."""
    B = np.zeros((n + 1, n + 1))
    for i in range(n + 1):
        for j in range(i, n + 1):
            B[i, j] = nchoosek(n, i) * nchoosek(n - i, n - j) * \
                (-1.0) ** (j - i)
    return B


@lru_cache(maxsize=None)
def bernstein_matrix_inv(n: int) -> np.ndarray:
    """B^-1: monomial coefficients back to control points."""
    return np.linalg.inv(bernstein_matrix(n))


@lru_cache(maxsize=None)
def q_base(n: int, phi: int, phi_n: int, dt: float) -> np.ndarray:
    """Per-segment derivative-energy Gram in control-point space
    (buildQBase, traj_optimizer.cpp:169-184)."""
    B = bernstein_matrix(n)
    Q = np.zeros((n + 1, n + 1))
    for k in range(phi, phi - phi_n, -1):
        Z = np.zeros((n + 1, n + 1))
        for i in range(n + 1):
            for j in range(n + 1):
                if i + j - 2 * k + 1 > 0:
                    Z[i, j] = (coef_derivative(i, k) * coef_derivative(j, k)
                               / (i + j - 2 * k + 1))
        Z = B @ Z @ B.T
        Q += Z * dt ** (-2 * k + 1)
    return Q


@lru_cache(maxsize=None)
def subdivision_matrix(n: int, a: float, b: float) -> np.ndarray:
    """S such that control points restricted to [a, b] are c @ S."""
    B = bernstein_matrix(n)
    A = np.zeros((n + 1, n + 1))
    for i in range(n + 1):
        for j in range(i + 1):
            A[i, j] = nchoosek(i, j) * (a ** j) * (b ** (i - j))
    return B @ A @ np.linalg.inv(B)


_tables = {}


def _table(name: str, n, dtype, device) -> torch.Tensor:
    """A constant tensor made once a (name, n, dtype, device): the basis
    exponents i, the binomials C(n, i), bernstein_matrix(n) ("basis"), the
    product table of polynomials with n = (d0, d1) coefficients ("conv"),
    the n + 1 points of linspace(0, 1) ("grid"), or gravity (n unused),
    so that no call copies host data to the device."""
    key = (name, n, dtype, device)
    if key not in _tables:
        if name == "exponent":
            t = torch.arange(n + 1, device=device)
        elif name == "binom":
            t = torch.tensor([float(nchoosek(n, k)) for k in range(n + 1)],
                             dtype=dtype, device=device)
        elif name == "basis":
            t = torch.as_tensor(bernstein_matrix(n), dtype=dtype,
                                device=device)
        elif name == "conv":
            t = torch.as_tensor(_conv_onehot(*n), dtype=dtype, device=device)
        elif name == "grid":
            t = torch.linspace(0.0, 1.0, n + 1, dtype=dtype, device=device)
        else:
            t = torch.tensor([0.0, 0.0, GRAVITY], dtype=dtype, device=device)
        _tables[key] = t
    return _tables[key]


def bernstein_basis(n: int, t: torch.Tensor) -> torch.Tensor:
    """Basis values b_{i,n}(t), shape t.shape + (n+1,)."""
    i = _table("exponent", n, None, t.device)
    binom = _table("binom", n, t.dtype, t.device)
    tt = t[..., None]

    def safe_pow(base, expo):
        return torch.where(expo == 0, torch.ones_like(base), base ** expo)
    return binom * safe_pow(tt, i) * safe_pow(1.0 - tt, n - i)


def bernstein_eval(ctrl: torch.Tensor, t) -> torch.Tensor:
    """Curve value at normalized time t; ctrl (..., n+1, d) -> (..., d)."""
    n = ctrl.shape[-2] - 1
    if isinstance(t, torch.Tensor):
        t = t.to(dtype=ctrl.dtype, device=ctrl.device)
    else:       # a fill on the device, not a host copy
        t = torch.full((), t, dtype=ctrl.dtype, device=ctrl.device)
    basis = bernstein_basis(n, t)
    return (basis[..., :, None] * ctrl).sum(-2)


def derivative_ctrl(ctrl: torch.Tensor, seg_time: float) -> torch.Tensor:
    """Control points of the derivative curve, (..., n+1, d) -> (..., n, d)."""
    n = ctrl.shape[-2] - 1
    return (ctrl[..., 1:, :] - ctrl[..., :-1, :]) * (n / seg_time)


def traj_state(traj: torch.Tensor, t: float, dt: float) -> dict:
    """Flat-output state along piecewise Bernstein trajectories
    (getStateFromControlPoints, polynomial.hpp:63-121).

    traj: (..., M, n+1, 3); t: time in [0, M dt].  Returns dict of
    pos/vel/acc/jerk/omega, each (..., 3)."""
    M = traj.shape[-3]
    m = min(max(int(math.floor(t / dt)), 0), M - 1)
    tau = t / dt - m
    seg = traj[..., m, :, :]
    vel_c = derivative_ctrl(seg, dt)
    acc_c = derivative_ctrl(vel_c, dt)
    jerk_c = derivative_ctrl(acc_c, dt)
    pos = bernstein_eval(seg, tau)
    vel = bernstein_eval(vel_c, tau)
    acc = bernstein_eval(acc_c, tau)
    jerk = bernstein_eval(jerk_c, tau)

    g = _table("gravity", 0, traj.dtype, traj.device)
    thrust = acc + g
    tnorm = torch.linalg.vector_norm(thrust, dim=-1, keepdim=True)
    z_body = thrust / torch.clamp(tnorm, min=1e-9)
    x_world = torch.zeros_like(z_body)
    x_world[..., 0] = 1.0
    y_body = torch.linalg.cross(z_body, x_world)
    y_body = y_body / torch.clamp(
        torch.linalg.vector_norm(y_body, dim=-1, keepdim=True), min=1e-9)
    x_body = torch.linalg.cross(y_body, z_body)
    jerk_orth = jerk - z_body * (jerk * z_body).sum(-1, keepdim=True)
    h_w = jerk_orth / torch.clamp(tnorm, min=1e-9)
    omega = torch.stack([-(h_w * y_body).sum(-1), (h_w * x_body).sum(-1),
                         torch.zeros_like(h_w[..., 0])], dim=-1)
    return {"pos": pos, "vel": vel, "acc": acc, "jerk": jerk,
            "omega": omega}


def traj_state_batch(trajs: torch.Tensor, t: float, dt: float) -> dict:
    """traj_state over a leading agent axis: trajs (N, M, n+1, 3)."""
    return traj_state(trajs, t, dt)


def bernstein_fitting(targets: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """Control points through target points (n+1, d) at normalised times
    ts (n+1,): the square, exactly interpolating case of the reference's
    least-squares bernsteinFitting (polynomial.hpp:198-222)."""
    n = targets.shape[0] - 1
    basis = bernstein_basis(n, ts.to(targets.dtype))   # rows: the times
    return torch.linalg.solve(basis, targets)


def subdivide(ctrl: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """The Bernstein curve ctrl (..., n+1, d) restricted to q(t) = p(b +
    a t) and written in Bernstein form again (subdivisionBernsteinCurve,
    polynomial.hpp:430-455)."""
    n = ctrl.shape[-2] - 1
    S = torch.as_tensor(subdivision_matrix(n, a, b), dtype=ctrl.dtype,
                        device=ctrl.device)
    return torch.einsum("ji,...jd->...id", S, ctrl)


# ----------------------------------------------------------------------
# real-root isolation and the minimum distance between Bernstein curves
# (realRootIsolation / distanceBetweenPolys, polynomial.hpp:243-413;
# bernstein.py:197-338)
# ----------------------------------------------------------------------

def power_coeffs(ctrl: torch.Tensor) -> torch.Tensor:
    """Monomial coefficients (ascending) of a Bernstein curve: ctrl
    (..., n+1) scalar control points -> (..., n+1) with p(t) = sum_j a_j
    t^j (the reference's coef = c^T B, polynomial.hpp:334-340)."""
    n = ctrl.shape[-1] - 1
    B = _table("basis", n, ctrl.dtype, ctrl.device)
    return torch.einsum("...i,ij->...j", ctrl, B)


def poly_eval(coef: torch.Tensor, t) -> torch.Tensor:
    """Horner evaluation of ascending monomial coefficients coef (..., D+1)
    at t, broadcastable against (...)."""
    t = torch.as_tensor(t, dtype=coef.dtype, device=coef.device)
    out = torch.zeros(torch.broadcast_shapes(coef.shape[:-1], t.shape),
                      dtype=coef.dtype, device=coef.device)
    for j in range(coef.shape[-1] - 1, -1, -1):
        out = out * t + coef[..., j]
    return out


@lru_cache(maxsize=None)
def _conv_onehot(d0: int, d1: int) -> np.ndarray:
    """T[j0, j1, j] = 1 iff j0 + j1 == j, for polynomial products."""
    T = np.zeros((d0, d1, d0 + d1 - 1))
    for j0 in range(d0):
        for j1 in range(d1):
            T[j0, j1, j0 + j1] = 1.0
    return T


def poly_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of two ascending-coefficient polynomials, batched:
    a (..., D0+1), b (..., D1+1) -> (..., D0+D1+1)."""
    T = _table("conv", (a.shape[-1], b.shape[-1]), a.dtype, a.device)
    return torch.einsum("...a,...b,abj->...j", a, b, T)


def real_roots(coef: torch.Tensor, n_grid: int = 64, iters: int = 40):
    """Roots of p in [0, 1]: sign changes bracketed on a uniform grid of
    n_grid cells, then a fixed number of bisections (the JAX package's
    fixed-shape form of the reference's Descartes/bisection queue).
    coef (..., D+1) ascending.  Returns (roots (..., n_grid), mask): root k
    lies in grid cell k; masked-out entries hold 1.0."""
    ts = _table("grid", n_grid, coef.dtype, coef.device)
    vals = poly_eval(coef[..., None, :], ts)            # (..., n_grid+1)
    sign_lo, sign_hi = vals[..., :-1], vals[..., 1:]
    bracket = sign_lo * sign_hi < 0.0                   # strict change
    exact = sign_lo == 0.0                              # grid-point root
    lo = ts[:-1].expand(bracket.shape)
    hi = ts[1:].expand(bracket.shape)
    neg_lo = sign_lo < 0.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        gm = poly_eval(coef[..., None, :], mid)
        go_right = torch.where(neg_lo, gm < 0.0, gm > 0.0)
        lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi,
                                                             mid)
    roots = torch.where(exact, ts[:-1].expand(bracket.shape),
                        0.5 * (lo + hi))
    mask = bracket | exact
    return torch.where(mask, roots, torch.ones_like(roots)), mask


def curve_pair_min_distance(ctrl_a: torch.Tensor, ctrl_b: torch.Tensor,
                            n_grid: int = 64, iters: int = 40):
    """Minimum distance between two time-aligned Bernstein curves on
    [0, 1]: ctrl_a/ctrl_b (..., n+1, d).  Returns (dist (...), closest
    (..., d) = a(t*) - b(t*)).  The interior minima of the relative curve
    are the roots of g = <delta, delta'> where g crosses from - to +,
    bisected; both endpoints always join the minimum (the JAX package's
    lower bound, bernstein.py:283-338)."""
    rel = ctrl_a - ctrl_b                                # (..., n+1, d)
    coef = power_coeffs(rel.transpose(-1, -2))           # (..., d, n+1)
    j = torch.arange(1, coef.shape[-1], dtype=coef.dtype,
                     device=coef.device)
    dcoef = coef[..., 1:] * j                            # (..., d, n)
    g = poly_multiply(coef, dcoef).sum(-2)               # (..., 2n)

    ts = _table("grid", n_grid, g.dtype, g.device)
    vals = poly_eval(g[..., None, :], ts)                # (..., n_grid+1)
    bracket = (vals[..., :-1] < 0.0) & (vals[..., 1:] > 0.0)
    lo = ts[:-1].expand(bracket.shape)
    hi = ts[1:].expand(bracket.shape)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        neg = poly_eval(g[..., None, :], mid) < 0.0
        lo, hi = torch.where(neg, mid, lo), torch.where(neg, hi, mid)
    t_cand = 0.5 * (lo + hi)                             # (..., n_grid)

    p_cand = bernstein_eval(rel[..., None, :, :], t_cand)
    d_cand = torch.sqrt((p_cand * p_cand).sum(-1))       # (..., n_grid)
    d_cand = torch.where(bracket, d_cand, float("inf"))
    d0 = torch.sqrt((rel[..., 0, :] ** 2).sum(-1))
    d1 = torch.sqrt((rel[..., -1, :] ** 2).sum(-1))
    all_d = torch.cat([d_cand, d0[..., None], d1[..., None]], dim=-1)
    all_p = torch.cat([p_cand, rel[..., 0:1, :], rel[..., -1:, :]], dim=-2)
    k = torch.argmin(all_d, dim=-1)
    dist = torch.gather(all_d, -1, k[..., None])[..., 0]
    closest = torch.gather(all_p, -2, k[..., None, None].expand(
        *k.shape, 1, all_p.shape[-1]))[..., 0, :]
    return dist, closest
