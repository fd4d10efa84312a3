"""Batched Cholesky factor + solve for the IPM, with their plain versions.

Port of the JAX package's TPU kernels behind ``chol_factor_solve``,
``chol_resolve`` and ``cholesky_batched`` (the note in ``csrc/chol.cu``
names them).  On a CUDA
tensor each wrapper launches its hand-written kernel (``csrc/chol.cu``) or
raises; on a CPU tensor it runs the plain PyTorch version below.  There is
no fallback from one to the other.

Semantics: lower Cholesky without a pivot floor, forward then backward
substitution; a non-SPD instance yields NaN in its own batch entry only.
The factor is a plain row-major ``(..., n, n)`` lower triangle, so it can
be handed to either version of ``chol_resolve``.  ``cholesky_batched``
returns the factor alone (zeros above the diagonal, a non-SPD entry's
lower triangle all NaN); as in the JAX package, nothing on the main path
calls it.
"""
from __future__ import annotations

import torch

from . import _build

MAX_N = 64

# launches of each kernel since the last reset (CUDA only; the plain
# versions never count)
factor_solve_launches = 0
resolve_launches = 0
factor_launches = 0


def reset_counts() -> None:
    global factor_solve_launches, resolve_launches, factor_launches
    factor_solve_launches = 0
    resolve_launches = 0
    factor_launches = 0


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------
def _solve_plain(L, rhs):
    z = torch.linalg.solve_triangular(L, rhs.unsqueeze(-1), upper=False)
    x = torch.linalg.solve_triangular(L.mT, z, upper=True)
    return x.squeeze(-1)


def chol_factor_solve_plain(H, rhs):
    """torch.linalg.cholesky raises on a non-PD matrix; jnp's Cholesky
    returns NaN.  cholesky_ex + a NaN fill of each failed entry keeps the
    JAX behaviour."""
    L, info = torch.linalg.cholesky_ex(H)
    L = torch.where((info > 0)[..., None, None],
                    torch.full_like(L, float("nan")), L)
    return L, _solve_plain(L, rhs)


def chol_resolve_plain(L, rhs):
    return _solve_plain(L, rhs)


def cholesky_batched_plain(H):
    """Lower factor of H (..., n, n): cholesky_ex with each failed entry's
    lower triangle NaN, zeros above the diagonal (jnp.linalg.cholesky's
    NaN on a non-SPD input, chol_pallas.py:13-14)."""
    L, info = torch.linalg.cholesky_ex(H)
    L = torch.where((info > 0)[..., None, None],
                    torch.full_like(L, float("nan")), L)
    return torch.tril(L)


# ----------------------------------------------------------------------
# CUDA kernels
# ----------------------------------------------------------------------
def _check(mat, rhs, what):
    if mat.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {mat.dtype} not supported "
                        "(float32 or float64)")
    n = mat.shape[-1]
    if mat.ndim < 2 or mat.shape[-2] != n:
        raise ValueError(f"{what}: expected (..., n, n), got "
                         f"{tuple(mat.shape)}")
    if rhs.shape != mat.shape[:-1] or rhs.dtype != mat.dtype or \
            rhs.device != mat.device:
        raise ValueError(f"{what}: rhs {tuple(rhs.shape)} {rhs.dtype} "
                         f"{rhs.device} does not match {tuple(mat.shape)} "
                         f"{mat.dtype} {mat.device}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{what}: n = {n} outside the kernel's range "
                         f"1..{MAX_N}")
    batch = mat.shape[:-2]
    return (mat.reshape(-1, n, n).contiguous(),
            rhs.reshape(-1, n).contiguous(), batch, n)


def _suffix(dtype):
    return "f32" if dtype == torch.float32 else "f64"


def _factor_solve_cuda(H, rhs):
    global factor_solve_launches
    lib = _build.load_library()
    H3, r2, batch, n = _check(H, rhs, "chol_factor_solve")
    B = H3.shape[0]
    L = torch.empty_like(H3)
    x = torch.empty_like(r2)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        err = getattr(lib, "lsc_chol_factor_solve_" + _suffix(H.dtype))(
            H3.data_ptr(), r2.data_ptr(), L.data_ptr(), x.data_ptr(),
            B, n, stream)
    if err:
        raise RuntimeError(f"chol_factor_solve kernel launch failed: CUDA "
                           f"error {err}")
    factor_solve_launches += 1
    return L.reshape(*batch, n, n), x.reshape(*batch, n)


def _factor_cuda(H):
    global factor_launches
    lib = _build.load_library()
    H3, _, batch, n = _check(H, H[..., 0], "cholesky_batched")
    B = H3.shape[0]
    L = torch.empty_like(H3)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        err = getattr(lib, "lsc_chol_factor_" + _suffix(H.dtype))(
            H3.data_ptr(), L.data_ptr(), B, n, stream)
    if err:
        raise RuntimeError(f"cholesky_batched kernel launch failed: CUDA "
                           f"error {err}")
    factor_launches += 1
    return L.reshape(*batch, n, n)


def _resolve_cuda(L, rhs):
    global resolve_launches
    lib = _build.load_library()
    L3, r2, batch, n = _check(L, rhs, "chol_resolve")
    B = L3.shape[0]
    x = torch.empty_like(r2)
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream(L.device).cuda_stream
        err = getattr(lib, "lsc_chol_resolve_" + _suffix(L.dtype))(
            L3.data_ptr(), r2.data_ptr(), x.data_ptr(), B, n, stream)
    if err:
        raise RuntimeError(f"chol_resolve kernel launch failed: CUDA "
                           f"error {err}")
    resolve_launches += 1
    return x.reshape(*batch, n)


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------
def chol_factor_solve(H, rhs):
    """Factor H (..., n, n) and solve H x = rhs (..., n).  Returns (L, x)
    with L the row-major lower factor for `chol_resolve`."""
    if H.device.type == "cpu":
        return chol_factor_solve_plain(H, rhs)
    if H.device.type == "cuda":
        return _factor_solve_cuda(H, rhs)
    raise RuntimeError(f"chol_factor_solve: no kernel for device {H.device}")


def chol_resolve(L, rhs):
    """Solve (L L^T) x = rhs with a factor from `chol_factor_solve`."""
    if L.device.type == "cpu":
        return chol_resolve_plain(L, rhs)
    if L.device.type == "cuda":
        return _resolve_cuda(L, rhs)
    raise RuntimeError(f"chol_resolve: no kernel for device {L.device}")


def cholesky_batched(H):
    """Lower Cholesky factor of H (..., n, n), zeros above the diagonal;
    a non-SPD entry comes back with its lower triangle NaN."""
    if H.device.type == "cpu":
        return cholesky_batched_plain(H)
    if H.device.type == "cuda":
        return _factor_cuda(H)
    raise RuntimeError(f"cholesky_batched: no kernel for device {H.device}")
