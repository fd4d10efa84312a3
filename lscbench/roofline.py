"""The least time the H100 could take for a kernel call: the yardstick of
the ``*_roofline`` metrics.

Copied from ``chip_smoke.py`` so that the benchmark keeps its own copy:
the peaks (``chip_smoke.py:436-444``), ``bound`` (``:459-463``),
``chol_bound`` (``:466-479``), ``tensor_bytes`` (``:482-483``) and
``fused_bound`` (``:1266-1294``).  Inputs are counted as read once and
outputs as written once; operations are those the call's algorithm needs
for these inputs (the fused IPM at each QP's own iteration count).
"""
from __future__ import annotations

# H100 peaks (NVIDIA's data sheet, SXM part, dense rates): f32 outside the
# tensor cores; f64 through the tensor cores (DMMA, IEEE f64 FMAs), the
# card's highest f64 rate and so the least time; HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound(nbytes, ops, peak=PEAK_F32_FLOPS):
    """(least ms the H100 could take, "bytes" or "operations"); ops at the
    rate `peak` (operations a second)."""
    t_b, t_o = nbytes / PEAK_BYTES, ops / peak
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


def chol_bound(kind, B, n, elem=4):
    """bound() of one chol call on B systems of size n: what the function
    must move (H's lower triangle in, all of L out with its zeros, or L's
    lower triangle in for resolve; the right-hand side in and x out) and
    its operations (the factor n^3 / 3, the two substitutions 2 n^2 a
    system) at the peak of the element's type (f32, or f64 for elem 8)."""
    tri, full = n * (n + 1) // 2, n * n
    nbytes, ops = {
        "factor_solve": (tri + full + 2 * n, n ** 3 / 3 + 2 * n * n),
        "resolve": (tri + 2 * n, 2 * n * n),
        "factor": (tri + full, n ** 3 / 3),
    }[kind]
    return bound(elem * B * nbytes, B * ops,
                 PEAK_F64_FLOPS if elem == 8 else PEAK_F32_FLOPS)


def tensor_bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def fused_ops_per_iter(P_blk, U, F_seg, C, correctors=0):
    """f32 operations of one fused IPM iteration on one QP (a multiply-add
    counts 2): the plane Gram through its per-segment weights W (D (D + 1)
    / 2 dimension pairs x R rows, D the dimension) and F_seg' W F_seg on
    the symmetric blocks, the static rows' symmetric Gram, the factor
    (nv^3 / 3), and for each of its 2 + correctors KKT solves and the exit
    test the two row products and (KKT only) the two triangular
    substitutions (nv^2 each).  Elementwise work is left out."""
    nf, D, Ru = P_blk.shape[-1], U.shape[0], U.shape[1]
    nv, MI = D * nf, F_seg.shape[0] * F_seg.shape[1]
    R, S = C * MI, D * Ru
    pairs = D * (D + 1) // 2            # the Gram's dimension pairs
    sym, full = nf * (nf + 1) / 2, nf * nf
    gram = (4 * pairs * R + 2 * MI * (D * sym + (pairs - D) * full) +
            2 * Ru * D * sym)
    rows = (2 * D * MI * nf + 2 * D * R + 2 * S * nf +      # A v
            2 * D * MI * C + 2 * nv * (Ru + MI))            # A' w
    kkts = 2 + correctors
    return gram + nv ** 3 / 3 + kkts * (rows + 2 * nv * nv) + rows


def fused_bound(args, kw, outputs, qp_iters_total):
    """bound() of one fused IPM call (ipm.ipm_lsc_fused's positional
    `args` and keywords `kw`): its inputs read once and its `outputs`
    written once, against the operations of the iterations its QPs ran,
    `qp_iters_total` (the sum of each QP's own count)."""
    P_blk, U, F_seg = args[0], args[3], args[8]
    C = args[5].shape[1]
    per_iter = fused_ops_per_iter(P_blk, U, F_seg, C,
                                  kw.get("correctors", 0))
    return bound(tensor_bytes(*args) + tensor_bytes(*outputs),
                 per_iter * qp_iters_total)
