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


def bernstein_basis(n: int, t: torch.Tensor) -> torch.Tensor:
    """Basis values b_{i,n}(t), shape t.shape + (n+1,)."""
    i = torch.arange(n + 1, device=t.device)
    binom = torch.tensor([float(nchoosek(n, k)) for k in range(n + 1)],
                         dtype=t.dtype, device=t.device)
    tt = t[..., None]

    def safe_pow(base, expo):
        return torch.where(expo == 0, torch.ones_like(base), base ** expo)
    return binom * safe_pow(tt, i) * safe_pow(1.0 - tt, n - i)


def bernstein_eval(ctrl: torch.Tensor, t) -> torch.Tensor:
    """Curve value at normalized time t; ctrl (..., n+1, d) -> (..., d)."""
    n = ctrl.shape[-2] - 1
    t = torch.as_tensor(t, dtype=ctrl.dtype, device=ctrl.device)
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

    g = torch.tensor([0.0, 0.0, GRAVITY], dtype=traj.dtype,
                     device=traj.device)
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
