"""Batched closest point between the origin and a small convex hull
(port of lsc_planner_tpu/ops/hull.py).

By Caratheodory the minimum-norm point of conv(P) in R^3 has support of at
most 3 points unless the origin is inside; for K <= 8 points every subset
of size 1..3 is solved as a bordered min-norm system, the feasible
candidate of least norm wins, and an optimality test detects the interior
case.  The small systems are scalarized over flat tensors exactly as in
the JAX package.
"""
from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _subsets(K: int, k: int) -> np.ndarray:
    return np.asarray(list(itertools.combinations(range(K), k)),
                      dtype=np.int64)


@lru_cache(maxsize=None)
def _subsets_on(K: int, k: int, device) -> torch.Tensor:
    """_subsets(K, k) on the device, made once (no host copy a call)."""
    return torch.as_tensor(_subsets(K, k), device=device)


def _solve_subsets(points, k: int, feas_tol: float = 1e-7):
    """Bordered min-norm systems for all subsets of size k of the K points.

    points: (..., K, 3).
    Returns (cand (..., S, 3), d2 (..., S), feasible (..., S))."""
    idx = _subsets_on(points.shape[-2], k, points.device)
    S = idx.shape[0]
    batch_shape = points.shape[:-2]
    # comp[j][d]: flat (batch*S,) component d of subset slot j
    comp = [[points[..., idx[:, j], d].reshape(-1) for d in range(3)]
            for j in range(k)]

    G = [[None] * k for _ in range(k)]
    for i in range(k):
        for j in range(i, k):
            G[i][j] = sum(comp[i][d] * comp[j][d] for d in range(3))
            G[j][i] = G[i][j]
    # relative ridge keeps degenerate (affinely dependent) subsets finite
    scale = sum(G[i][i] for i in range(k)) / k
    ridge = 1e-7 * scale + 1e-30
    for i in range(k):
        G[i][i] = G[i][i] + ridge

    L = [[None] * k for _ in range(k)]
    for j in range(k):
        s_ = G[j][j]
        for p_ in range(j):
            s_ = s_ - L[j][p_] * L[j][p_]
        diag = torch.sqrt(torch.clamp(s_, min=1e-30))
        L[j][j] = diag
        inv = 1.0 / diag
        for i in range(j + 1, k):
            s2 = G[i][j]
            for p_ in range(j):
                s2 = s2 - L[i][p_] * L[j][p_]
            L[i][j] = s2 * inv

    # G w = 1, lam = w / sum(w)
    y = [None] * k
    for i in range(k):
        s_ = torch.ones_like(scale)
        for p_ in range(i):
            s_ = s_ - L[i][p_] * y[p_]
        y[i] = s_ / L[i][i]
    w = [None] * k
    for i in reversed(range(k)):
        s_ = y[i]
        for p_ in range(i + 1, k):
            s_ = s_ - L[p_][i] * w[p_]
        w[i] = s_ / L[i][i]
    denom = sum(w)
    lam = [w[i] / denom for i in range(k)]

    feasible = torch.ones_like(scale, dtype=torch.bool)
    for i in range(k):
        feasible = feasible & (lam[i] > -feas_tol) & torch.isfinite(lam[i])
    lam = [torch.clamp(l, min=0.0) for l in lam]
    lam_sum = torch.clamp(sum(lam), min=1e-12)
    lam = [l / lam_sum for l in lam]

    cand_d = [sum(lam[j] * comp[j][d] for j in range(k)) for d in range(3)]
    d2 = sum(c * c for c in cand_d)

    out_shape = batch_shape + (S,)
    cand = torch.stack([c.reshape(out_shape) for c in cand_d], dim=-1)
    return cand, d2.reshape(out_shape), feasible.reshape(out_shape)


def closest_point_to_hull(points, max_support: int = 3):
    """Exact closest point of conv(points) to the origin, batched.

    points: (..., K, 3), K <= 8 (a segment's n + 1 = 6 control points).
    Returns (closest (..., 3), dist (...,))."""
    if points.shape[-2] > 8:
        raise ValueError("the reference's hull enumeration takes K <= 8")
    return _closest_point_enum(points, max_support)


def _closest_point_enum(points, max_support):
    K = points.shape[-2]
    cands, d2s, feas = [], [], []
    for k in range(1, min(K, max_support) + 1):
        c, d2, f = _solve_subsets(points, k)
        cands.append(c)
        d2s.append(d2)
        feas.append(f)
    cand = torch.cat(cands, dim=-2)                  # (..., T, 3)
    d2 = torch.cat(d2s, dim=-1)                      # (..., T)
    feas = torch.cat(feas, dim=-1)
    d2 = torch.where(feas, d2, torch.full_like(d2, float("inf")))
    cand = torch.where(torch.isfinite(cand), cand, torch.zeros_like(cand))
    # first minimum, as the JAX masked-sum selection picks it
    first = torch.argmin(d2, dim=-1, keepdim=True)
    d2_best = torch.gather(d2, -1, first)[..., 0]
    closest = torch.gather(
        cand, -2, first[..., None].expand(*first.shape, 3))[..., 0, :]

    if K > max_support >= 3:
        # interior test in residual form: c is the projection iff
        # (p_i - c) . c >= 0 for all i (see the JAX package for why the
        # residual form is the numerically safe one)
        q = points - closest[..., None, :]
        qc_min = torch.amin((q * closest[..., None, :]).sum(-1), dim=-1)
        pscale = torch.amax((points * points).sum(-1), dim=-1)
        tol = 3e-4 if points.dtype == torch.float32 else 1e-6
        inside = qc_min < -tol * pscale
        closest = torch.where(inside[..., None], torch.zeros_like(closest),
                              closest)
        d2_best = torch.where(inside, torch.zeros_like(d2_best), d2_best)

    return closest, torch.sqrt(d2_best)


def hull_normal(points, eps: float = 1e-10):
    """Unit vector from the origin toward the hull's closest point (the LSC
    normal for relative control points); +x when the origin is inside."""
    closest, dist = closest_point_to_hull(points)
    safe = dist[..., None] > eps
    fallback = torch.zeros_like(closest)
    fallback[..., 0].fill_(1.0)
    normal = torch.where(safe, closest / torch.clamp(dist[..., None],
                                                      min=eps), fallback)
    return normal, dist
