"""Batched Cholesky factor + solve, plain PyTorch (frozen copy of the
port's ``ops/chol.py`` plain versions: ``torch.linalg.cholesky_ex`` and
two triangular solves, never a hand-written kernel).
"""
from __future__ import annotations

import torch


def _solve_plain(L, rhs):
    z = torch.linalg.solve_triangular(L, rhs.unsqueeze(-1), upper=False)
    x = torch.linalg.solve_triangular(L.mT, z, upper=True)
    return x.squeeze(-1)


def cholesky_batched_plain(H):
    """Lower factor of H (..., n, n): cholesky_ex with each failed entry's
    lower triangle NaN, zeros above the diagonal (jnp.linalg.cholesky's
    NaN on a non-SPD input, chol_pallas.py:13-14).  torch.linalg.cholesky
    raises on a non-PD matrix; cholesky_ex + the NaN fill keeps the JAX
    behaviour, and zeros above the diagonal keep the kernels' layout."""
    L, info = torch.linalg.cholesky_ex(H)
    L = torch.where((info > 0)[..., None, None],
                    torch.full_like(L, float("nan")), L)
    return torch.tril(L)


def chol_factor_solve_plain(H, rhs):
    """(cholesky_batched_plain(H), the solve of H x = rhs with it)."""
    L = cholesky_batched_plain(H)
    return L, _solve_plain(L, rhs)


def chol_resolve_plain(L, rhs):
    return _solve_plain(L, rhs)


chol_factor_solve = chol_factor_solve_plain
chol_resolve = chol_resolve_plain
cholesky_batched = cholesky_batched_plain
