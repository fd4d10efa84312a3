"""Bernstein-polynomial algebra (port of lsc_planner_tpu/ops/bernstein.py).

The static matrices (basis change, jerk Gram, subdivision) are float64
numpy built once, as in the JAX package.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

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


_tables = {}


# ----------------------------------------------------------------------
# real-root isolation and the minimum distance between Bernstein curves
# (realRootIsolation / distanceBetweenPolys, polynomial.hpp:243-413;
# bernstein.py:197-338)
# ----------------------------------------------------------------------
