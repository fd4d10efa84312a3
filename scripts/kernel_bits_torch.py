#!/usr/bin/env python3
"""Dump the port's kernels' outputs on fixed inputs, and compare two dumps
bit for bit: a check that a kernel source change kept a kernel's bits.

    PYTHONPATH=<checkout> python3 scripts/kernel_bits_torch.py dump OUT.pt
    python3 scripts/kernel_bits_torch.py compare A.pt B.pt

`dump` runs on one CUDA GPU with the package on PYTHONPATH (this checkout,
or another one unpacked with `git archive`): the fused IPM in 3-D at the
main path's shapes (B, C) = (1024, 32), (64, 64), (128, 128), Param's
tolerances, with each QP's own iteration count; factor_solve, resolve and
the factor alone at n = 39 and 64, f32 and f64; and each fused call's
time (CUDA events, median of 20).  The inputs are made from numpy seeds
with the package's own tables, so two checkouts get the same inputs.
`compare` prints, as one JSON line, the card that made each dump, the
differing bits of every output (0 where equal) and both dumps' times, and
exits non-zero when any bits differ.  Compare two checkouts' times only
from dumps made in one call on one card, in turns (A, B, B, A).
"""
import json
import statistics
import sys

import numpy as np
import torch


def fused_inputs(B, C, seed):
    """ipm_lsc_fused's inputs on the production row structure (as
    tests/test_torch_cuda.py::fused_problem builds them), float32."""
    from lsc_planner_tpu_torch import Param
    from lsc_planner_tpu_torch.planner.optimizer import TrajOptimizer

    rng = np.random.default_rng(seed)
    opt = TrajOptimizer(Param())
    nf, M, n1 = opt.nf, opt.M, opt.n + 1
    U = opt.static_blocked[0]
    U = U / np.maximum(np.linalg.norm(U, axis=-1, keepdims=True), 1e-3)
    Lb = rng.normal(size=(B, nf, nf)) * 0.3
    P_blk = Lb @ np.swapaxes(Lb, -1, -2) + 2.0 * np.eye(nf)
    q = rng.normal(size=(B, 3 * nf))
    y0 = rng.normal(size=(B, 3 * nf)) * 0.1
    b_pairs = -rng.uniform(0.5, 5.0, size=(B, 2, U.shape[0] * U.shape[1]))
    nsc = rng.normal(size=(B, C, M, 3))
    F_seg = opt.F_seg
    row = np.linalg.norm(nsc, axis=-1)[..., None] * \
        np.linalg.norm(F_seg, axis=-1)
    live = (rng.uniform(size=(B, C, M, n1)) > 0.3) & (row >= 1e-3)
    scale = np.where(live, 1.0 / np.maximum(row, 1e-3), 0.0)
    b_pl = np.where(live, -rng.uniform(0.05, 1.0, size=row.shape) * row *
                    scale, -1.0)
    sigma = np.abs(np.einsum("nff->nf", P_blk)).mean(-1)
    return [torch.as_tensor(a, dtype=torch.float32, device="cuda")
            for a in (P_blk, q, y0, U, b_pairs, nsc, scale, b_pl, F_seg,
                      sigma)]


def spd_inputs(B, n, seed, dtype):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, 3 * n, n))
    d = np.exp(rng.uniform(-np.log(1e3), np.log(1e3), size=(B, 3 * n)))
    H = np.eye(n) + np.einsum("brv,br,brw->bvw", A, d, A)
    dsc = 1.0 / np.sqrt(np.einsum("bvv->bv", H))
    return [torch.as_tensor(a, dtype=dtype, device="cuda")
            for a in (H * dsc[:, :, None] * dsc[:, None, :],
                      rng.normal(size=(B, n)))]


def median_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def dump(path):
    from lsc_planner_tpu_torch.ops import chol, ipm

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bits_torch.py dump needs a CUDA device")
    out = {"device": torch.cuda.get_device_name(0), "ms": {}}
    kw = dict(iters=40, tol_gap=1e-3, tol_rp=1e-4, tol_rd=0.2, tol_step=1e-3,
              correctors=1, qp_counts=True)
    for B, C in ((1024, 32), (64, 64), (128, 128)):
        args = fused_inputs(B, C, B + C)
        res = ipm.ipm_lsc_fused(*args, **kw)
        for name, t in zip(("y", "lam_s", "lam_p", "gap", "iters"), res):
            out[f"fused B={B} C={C} {name}"] = t.cpu()
        out["ms"][f"fused B={B} C={C}"] = median_ms(
            lambda: ipm.ipm_lsc_fused(*args, **kw))
    for n in (39, 64):
        for dtype in (torch.float32, torch.float64):
            H, r = spd_inputs(64, n, n, dtype)
            L, x = chol.chol_factor_solve(H, r)
            key = f"chol n={n} {str(dtype)[6:]}"
            out[key + " L"] = L.cpu()
            out[key + " x"] = x.cpu()
            out[key + " resolve"] = chol.chol_resolve(L, r).cpu()
            out[key + " factor"] = chol.cholesky_batched(H).cpu()
    torch.save(out, path)


def differing_bits(a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        return -1
    if a.dtype == torch.bool:
        return int((a != b).sum())
    view = {4: torch.int32, 8: torch.int64}[a.element_size()]
    x = torch.bitwise_xor(a.view(view), b.view(view)).to(torch.int64)
    if a.element_size() == 4:
        x = x & 0xFFFFFFFF
    return sum(int(((x >> i) & 1).sum()) for i in range(8 * a.element_size()))


def compare(path_a, path_b):
    a, b = torch.load(path_a), torch.load(path_b)
    diffs = {k: differing_bits(a[k], b[k]) for k in a
             if k not in ("device", "ms") and k in b}
    print(json.dumps({"devices": [a["device"], b["device"]],
                      "missing": sorted(set(a) ^ set(b)),
                      "differing_bits": diffs,
                      "ms": [a["ms"], b["ms"]]}))
    return 0 if not any(diffs.values()) and set(a) == set(b) else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["dump"] and len(sys.argv) == 3:
        dump(sys.argv[2])
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) == 4:
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        sys.exit(__doc__)
