"""CUDA kernel checks for the port (skip without a GPU).

These tests import no JAX, so they also run on a machine without it:
    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from lsc_planner_tpu_torch.ops import _build, chol, ipm, qp, wavefront
from lsc_planner_tpu_torch.ops import corridor as corridor_ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU with "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py")
    return torch.device("cuda")


def forest_mission(mis, seed, qn=20, n_trees=60,
                   world=(-5.0, -5.0, 0.0, 5.0, 5.0, 2.5)):
    """A seeded synthetic forest (simple_forest's statistics at qn = 20,
    n_trees = 60): make_random_mission(qn, world, seed) of the missions
    module `mis` (either package's), plus n_trees full-height 0.3 x 0.3 m
    tree columns as `static` boxes, centres uniform over the world (inset
    0.15 m) and none within 0.5 m (horizontally) of a start or goal."""
    m = mis.make_random_mission(qn, world=world, seed=seed)
    keep = np.array([a.start[:2] for a in m.agents] +
                    [a.goal[:2] for a in m.agents], dtype=np.float64)
    lo, hi = np.asarray(world[:2]) + 0.15, np.asarray(world[3:5]) - 0.15
    zc, zh = 0.5 * (world[2] + world[5]), 0.5 * (world[5] - world[2])
    rng = np.random.default_rng(seed)
    trees = []
    while len(trees) < n_trees:
        c = rng.uniform(lo, hi)
        if np.min(np.linalg.norm(keep - c, axis=1)) > 0.5:
            trees.append(c)
    m.obstacles = [mis.ObstacleSpec(kind="static",
                                    pose=np.array([c[0], c[1], zc]),
                                    dimensions=np.array([0.15, 0.15, zh]))
                   for c in trees]
    return m


def ipm_like_system(B, n=39, seed=0, cond=1e3):
    """Jacobi-scaled SPD matrices shaped like the IPM's Hs (qp.py:257-258):
    P + A'DA with an interior-point spread of D, then unit diagonal."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, 3 * n, n))
    d = np.exp(rng.uniform(-np.log(cond), np.log(cond), size=(B, 3 * n)))
    H = np.eye(n) + np.einsum("brv,br,brw->bvw", A, d, A)
    dsc = 1.0 / np.sqrt(np.einsum("bvv->bv", H))
    Hs = H * dsc[:, :, None] * dsc[:, None, :]
    return Hs, rng.normal(size=(B, n)), rng.normal(size=(B, n))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 63, 64, 130])
def test_chol_kernels_match_plain_f32(cuda, B):
    Hs, r1, r2 = ipm_like_system(B)
    H64 = torch.as_tensor(Hs, device=cuda)
    L64, x64 = chol.chol_factor_solve_plain(H64, torch.as_tensor(r1, device=cuda))
    y64 = chol.chol_resolve_plain(L64, torch.as_tensor(r2, device=cuda))

    H = H64.float()
    R1 = torch.as_tensor(r1, device=cuda, dtype=torch.float32)
    R2 = torch.as_tensor(r2, device=cuda, dtype=torch.float32)
    Lp, xp = chol.chol_factor_solve_plain(H, R1)
    yp = chol.chol_resolve_plain(Lp, R2)
    chol.reset_counts()
    Lk, xk = chol.chol_factor_solve(H, R1)
    yk = chol.chol_resolve(Lk, R2)
    torch.cuda.synchronize()
    assert (chol.factor_solve_launches, chol.resolve_launches) == (1, 1)

    # the kernel's error against the f64 solve: within 4x the plain f32
    # version's error, plus 1e-6 (different rounding order)
    for got, plain, ref in ((xk, xp, x64), (yk, yp, y64)):
        e_k = (got.double() - ref).abs().max().item()
        e_p = (plain.double() - ref).abs().max().item()
        assert e_k <= 4 * e_p + 1e-6, (e_k, e_p)
    assert torch.allclose(Lk.double(), L64, rtol=1e-4, atol=1e-5)
    assert torch.equal(torch.triu(Lk, 1), torch.zeros_like(Lk))


@pytest.mark.cuda
def test_chol_kernels_f64(cuda):
    Hs, r1, r2 = ipm_like_system(8, seed=1)
    H = torch.as_tensor(Hs, device=cuda)
    R1 = torch.as_tensor(r1, device=cuda)
    Lp, xp = chol.chol_factor_solve_plain(H, R1)
    Lk, xk = chol.chol_factor_solve(H, R1)
    torch.testing.assert_close(xk, xp, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(Lk, Lp, rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
def test_chol_kernel_nan_stays_in_its_entry(cuda):
    Hs, r1, r2 = ipm_like_system(64, seed=2)
    Hs[5, 7, 7] = -1.0                  # non-SPD instance 5
    H = torch.as_tensor(Hs, device=cuda, dtype=torch.float32)
    L, x = chol.chol_factor_solve(H, torch.as_tensor(r1, device=cuda,
                                                     dtype=torch.float32))
    y = chol.chol_resolve(L, torch.as_tensor(r2, device=cuda,
                                             dtype=torch.float32))
    bad = ~torch.isfinite(x).all(-1)
    assert bad.nonzero().flatten().tolist() == [5]
    assert (~torch.isfinite(y).all(-1)).nonzero().flatten().tolist() == [5]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B, n", [(1, 39), (63, 39), (64, 39), (130, 39),
                                  (63, 64)])
def test_factor_solve_nonspd_entry_in_a_shared_block(cuda, B, n, dtype):
    """factor_solve factors four matrices a block, one a warp: a non-SPD
    entry (B // 2, inside a block of healthy ones) comes back with its
    lower triangle and x all NaN; every other entry matches the f64 plain
    version (f32: within 4x the plain f32 error + 1e-6; f64: rtol 1e-10),
    with zeros above the diagonal, and chol_resolve takes its factor.  At
    the QP's n = 39 and at n = 64, the kernel's two register capacities."""
    Hs, r1, r2 = ipm_like_system(B, n, seed=100 + B)
    bad = B // 2 if B > 1 else None
    if bad is not None:
        Hs[bad, 7, 7] = -1.0
    H64 = torch.as_tensor(Hs, device=cuda)
    R64 = torch.as_tensor(r1, device=cuda)
    L64, x64 = chol.chol_factor_solve_plain(H64, R64)
    H, R1 = H64.to(dtype), R64.to(dtype)
    chol.reset_counts()
    Lk, xk = chol.chol_factor_solve(H, R1)
    yk = chol.chol_resolve(Lk, torch.as_tensor(r2, device=cuda, dtype=dtype))
    torch.cuda.synchronize()
    assert chol.factor_solve_launches == 1
    want = [] if bad is None else [bad]
    assert (~torch.isfinite(xk).all(-1)).nonzero().flatten().tolist() == want
    assert (~torch.isfinite(yk).all(-1)).nonzero().flatten().tolist() == want
    if bad is not None:
        low = torch.tril(torch.ones_like(Lk[bad], dtype=torch.bool))
        assert torch.isnan(Lk[bad][low]).all()
    assert torch.equal(torch.triu(Lk, 1), torch.zeros_like(Lk))
    ok = torch.arange(B, device=cuda) != (-1 if bad is None else bad)
    if dtype == torch.float64:
        torch.testing.assert_close(xk[ok], x64[ok], rtol=1e-10, atol=1e-10)
    else:
        xp = chol.chol_factor_solve_plain(H, R1)[1]
        e_k = (xk[ok].double() - x64[ok]).abs().max().item()
        e_p = (xp[ok].double() - x64[ok]).abs().max().item()
        assert e_k <= 4 * e_p + 1e-6, (e_k, e_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [39, 64])
@pytest.mark.parametrize("B", [1, 5, 63, 64, 130])
def test_resolve_kernel_matches_f64_and_factor_solve(cuda, B, n, dtype):
    """resolve, one warp a matrix on factor_solve's solve: against the f64
    solve (f32: within 4x the plain f32 version's error + 1e-6; f64: rtol
    1e-10), and for factor_solve's own L and rhs it returns factor_solve's
    x bit for bit.  B not a multiple of four masks a block's last warps."""
    Hs, r1, r2 = ipm_like_system(B, n, seed=200 + B + n)
    H64 = torch.as_tensor(Hs, device=cuda)
    L64 = chol.chol_factor_solve_plain(H64, torch.as_tensor(r1,
                                                           device=cuda))[0]
    y64 = chol.chol_resolve_plain(L64, torch.as_tensor(r2, device=cuda))
    H = H64.to(dtype)
    R1 = torch.as_tensor(r1, device=cuda, dtype=dtype)
    R2 = torch.as_tensor(r2, device=cuda, dtype=dtype)
    chol.reset_counts()
    Lk, xk = chol.chol_factor_solve(H, R1)
    yk = chol.chol_resolve(Lk, R2)
    xr = chol.chol_resolve(Lk, R1)
    torch.cuda.synchronize()
    assert chol.resolve_launches == 2
    assert torch.equal(xr, xk)
    if dtype == torch.float64:
        torch.testing.assert_close(yk, y64, rtol=1e-10, atol=1e-10)
    else:
        Lp = chol.chol_factor_solve_plain(H, R1)[0]
        yp = chol.chol_resolve_plain(Lp, R2)
        e_k = (yk.double() - y64).abs().max().item()
        e_p = (yp.double() - y64).abs().max().item()
        assert e_k <= 4 * e_p + 1e-6, (e_k, e_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_resolve_nan_factor_stays_in_its_entry(cuda, dtype):
    """A factor whose lower triangle is NaN (factor_solve's answer to a
    non-SPD entry) gives an all-NaN x in its entry; the three other
    matrices of its block (entries 4-7) and every other entry come back
    bit for bit as without it."""
    Hs, r1, r2 = ipm_like_system(64, seed=3)
    L = chol.chol_factor_solve(
        torch.as_tensor(Hs, device=cuda, dtype=dtype),
        torch.as_tensor(r1, device=cuda, dtype=dtype))[0]
    R2 = torch.as_tensor(r2, device=cuda, dtype=dtype)
    clean = chol.chol_resolve(L, R2)
    low = torch.tril(torch.ones_like(L[5], dtype=torch.bool))
    L[5][low] = float("nan")
    y = chol.chol_resolve(L, R2)
    torch.cuda.synchronize()
    assert torch.isnan(y[5]).all()
    ok = torch.arange(64, device=cuda) != 5
    assert torch.equal(y[ok], clean[ok])

def fused_problem(B, C, seed=0, dim=3):
    """Inputs of ``ipm.ipm_lsc_fused`` on the production row structure
    (the optimizer's unit-norm U and F_seg), built as tests/test_qp.py:
    169-181 builds its QPs: P_blk = L L' + 2 I, about 70 % of the plane
    rows live.  Every bound is negative, so the start d = 0 is strictly
    feasible and each QP has a solution however many rows it has.  float64
    numpy arrays in the wrapper's argument order; dim 2: a 2-D world's."""
    from lsc_planner_tpu_torch import Param
    from lsc_planner_tpu_torch.planner.optimizer import TrajOptimizer

    rng = np.random.default_rng(seed)
    opt = TrajOptimizer(Param(world_dimension=dim))
    nf, M, n1 = opt.nf, opt.M, opt.n + 1
    U = opt.static_blocked[0]
    U = U / np.maximum(np.linalg.norm(U, axis=-1, keepdims=True), 1e-3)
    Lb = rng.normal(size=(B, nf, nf)) * 0.3
    P_blk = Lb @ np.swapaxes(Lb, -1, -2) + 2.0 * np.eye(nf)
    q = rng.normal(size=(B, dim * nf))
    y0 = rng.normal(size=(B, dim * nf)) * 0.1
    b_pairs = -rng.uniform(0.5, 5.0, size=(B, 2, U.shape[0] * U.shape[1]))
    nsc = rng.normal(size=(B, C, M, dim))
    F_seg = opt.F_seg
    row = np.linalg.norm(nsc, axis=-1)[..., None] * \
        np.linalg.norm(F_seg, axis=-1)
    live = (rng.uniform(size=(B, C, M, n1)) > 0.3) & (row >= 1e-3)
    scale = np.where(live, 1.0 / np.maximum(row, 1e-3), 0.0)
    b_pl = np.where(live, -rng.uniform(0.05, 1.0, size=row.shape) * row *
                    scale, -1.0)
    sigma = np.abs(np.einsum("nff->nf", P_blk)).mean(-1)
    return [P_blk, q, y0, U, b_pairs, nsc, scale, b_pl, F_seg, sigma]


PROD_TOL = dict(iters=40, tol_gap=1e-3, tol_rp=1e-4, tol_rd=0.2,
                tol_step=1e-3, correctors=1)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 64, 130, 1024])
@pytest.mark.parametrize("C", [5, 32, 64, 128, 256])
def test_fused_kernel_matches_plain(cuda, B, C):
    """The kernel against its plain version in f32 on the card, both held
    to an f64 plain run: the kernel's y error within 4x the plain f32
    error + 1e-4, the same tile iteration counts within 1.  B = 130 and
    1024 leave the last block part-filled; at C = 128 and 256 a block's
    shared memory holds the rows of one QP at most."""
    arr = fused_problem(B, C, seed=B + C)
    a64 = [torch.as_tensor(a, device=cuda) for a in arr]
    a32 = [a.float() for a in a64]
    for kw in (dict(iters=3, tol_gap=0.0, tol_rp=0.0, correctors=1),
               PROD_TOL):
        ref = ipm.ipm_lsc_fused_plain(*a64, **kw)
        plain = ipm.ipm_lsc_fused_plain(*a32, **kw)
        ipm.reset_counts()
        got = ipm.ipm_lsc_fused(*a32, **kw)
        torch.cuda.synchronize()
        assert ipm.fused_launches == 1
        e_k = (got[0].double() - ref[0]).abs().max().item()
        e_p = (plain[0].double() - ref[0]).abs().max().item()
        assert e_k <= 4 * e_p + 1e-4, (kw["iters"], e_k, e_p)
        assert (got[4] - plain[4]).abs().max().item() <= 1
        for t in got[:4]:
            assert torch.isfinite(t).all()
        # each QP's own count: its tile maximum is the reported count
        own = ipm.ipm_lsc_fused(*a32, **kw, qp_counts=True)[4]
        own_p = ipm.ipm_lsc_fused_plain(*a32, **kw, qp_counts=True)[4]
        assert torch.equal(ipm.tile_counts(own), got[4])
        assert (own - own_p).abs().max().item() <= 1


def _shrink_segments(arr, M):
    """The fused problem with its first M segments only (MI = M (n + 1)):
    a shape the kernel is not specialised for."""
    arr = list(arr)
    for i in (5, 6, 7):
        arr[i] = np.ascontiguousarray(arr[i][:, :, :M])
    arr[8] = np.ascontiguousarray(arr[8][:M])
    return arr


@pytest.mark.cuda
@pytest.mark.parametrize("B,C", [(130, 32), (130, 128)])
def test_fused_kernel_generic_shape_and_row_modes(cuda, B, C):
    """The generic instantiation (M = 4, MI = 24) against the plain version
    as in test_fused_kernel_matches_plain; and on the main path's shape
    the rows in shared memory and in device memory give the same bits."""
    arr = _shrink_segments(fused_problem(B, C, seed=7), 4)
    a64 = [torch.as_tensor(a, device=cuda) for a in arr]
    a32 = [a.float() for a in a64]
    U, F = arr[3], arr[8]
    assert ipm.fused_plan(B, U.shape[-1], U.shape[1], C, 4, F.shape[1])[
        "specialised"] == 0
    for kw in (dict(iters=3, tol_gap=0.0, tol_rp=0.0, correctors=1),
               PROD_TOL):
        ref = ipm.ipm_lsc_fused_plain(*a64, **kw)
        plain = ipm.ipm_lsc_fused_plain(*a32, **kw)
        got = ipm.ipm_lsc_fused(*a32, **kw)
        torch.cuda.synchronize()
        e_k = (got[0].double() - ref[0]).abs().max().item()
        e_p = (plain[0].double() - ref[0]).abs().max().item()
        assert e_k <= 4 * e_p + 1e-4, (kw["iters"], e_k, e_p)
        assert (got[4] - plain[4]).abs().max().item() <= 1
    a32 = [torch.as_tensor(a, device=cuda).float()
           for a in fused_problem(B, C, seed=8)]
    assert ipm.fused_plan(B, 13, a32[3].shape[1], C, 5, 6)["specialised"]
    outs = [ipm._fused_cuda(*a32, **PROD_TOL, reg=1e-8, s_min=1.0,
                            rows=rows)
            for rows in ("smem", "global")]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["smem", "global"])
def test_fused_kernel_nan_qp_leaves_its_block_mates_alone(cuda, rows):
    """A QP whose q is NaN rejects every step; the QPs that share its
    block (one warp a QP) return the bits of a batch without it."""
    arr = [torch.as_tensor(a, device=cuda).float()
           for a in fused_problem(64, 32, seed=9)]
    kw = dict(iters=40, reg=1e-8, s_min=1.0, tol_gap=1e-3, tol_rp=1e-4,
              tol_rd=0.2, tol_step=1e-3, correctors=1, qp_counts=True,
              rows=rows)
    clean = ipm._fused_cuda(*arr, **kw)
    arr[1] = arr[1].clone()
    arr[1][5] = float("nan")
    got = ipm._fused_cuda(*arr, **kw)
    torch.cuda.synchronize()
    keep = torch.arange(64, device=cuda) != 5
    for a, b in zip(got, clean):
        assert torch.equal(a[keep], b[keep])
    assert int(got[4][5]) == 40                 # never latched done


@pytest.mark.cuda
def test_fused_kernel_nonspd_entry_stays_finite_and_alone(cuda):
    """An indefinite cost block makes one QP's Gram non-SPD: the pivot
    floor keeps its solve finite, and the other QPs' results are those of
    a batch without it."""
    arr = fused_problem(64, 32, seed=3)
    bad = arr[0].copy()
    bad[5] = 100.0 * np.ones_like(bad[5]) - 50.0 * np.eye(bad.shape[-1])
    kw = dict(iters=3, tol_gap=0.0, tol_rp=0.0, correctors=1)
    clean = ipm.ipm_lsc_fused(*[torch.as_tensor(a, device=cuda).float()
                                for a in arr], **kw)
    arr[0] = bad
    got = ipm.ipm_lsc_fused(*[torch.as_tensor(a, device=cuda).float()
                              for a in arr], **kw)
    torch.cuda.synchronize()
    for t in got[:4]:
        assert torch.isfinite(t).all()
    keep = torch.arange(64, device=cuda) != 5
    for a, b in zip(got[:4], clean[:4]):
        assert torch.equal(a[keep], b[keep])


@pytest.mark.cuda
def test_fused_dispatch_raises_and_off_runs(cuda):
    """At N >= 128 under "auto" the cycle solves through the fused IPM
    kernel (one launch, no chol launch), with K-NN pruning (K = 32) and at
    Param's all-pairs default (C = 128 row groups a QP).
    "off" keeps the JAX meaning and solves through the factored rows and
    the chol kernels.  An unsupported dtype raises on the card."""
    from lsc_planner_tpu_torch import GoalMode, Param, make_circle_mission
    from lsc_planner_tpu_torch.sim.simulator import SyncSimulator

    mission = make_circle_mission(128, radius=18.4,
                                  world=(-20.4, -20.4, 0, 20.4, 20.4, 2.5))
    sim = SyncSimulator(mission, Param(goal_mode=GoalMode.PRIOR_BASED,
                                       max_neighbors=32), device=cuda)
    chol.reset_counts()
    ipm.reset_counts()
    state, info = sim.cycle(sim.initial_state())
    torch.cuda.synchronize()
    assert ipm.fused_launches == 1
    assert chol.factor_solve_launches == chol.resolve_launches == 0
    assert torch.isfinite(state.traj).all()
    assert not bool(info.qp_failed.any())
    assert info.qp_iters.shape == (128,)

    sim = SyncSimulator(mission, Param(goal_mode=GoalMode.PRIOR_BASED),
                        device=cuda)
    chol.reset_counts()
    ipm.reset_counts()
    state, info = sim.cycle(sim.initial_state())
    torch.cuda.synchronize()
    assert ipm.fused_launches == 1
    assert chol.factor_solve_launches == chol.resolve_launches == 0
    assert torch.isfinite(state.traj).all()
    assert not bool(info.qp_failed.any())

    sim = SyncSimulator(mission, Param(goal_mode=GoalMode.PRIOR_BASED,
                                       qp_fused_mode="off"), device=cuda)
    chol.reset_counts()
    ipm.reset_counts()
    state, info = sim.cycle(sim.initial_state())
    torch.cuda.synchronize()
    assert ipm.fused_launches == 0
    assert torch.isfinite(state.traj).all()
    assert not bool(info.qp_failed.any())
    # the early exit is checked every EXIT_CHECK_EVERY iterations
    every = qp.EXIT_CHECK_EVERY
    iters = int(info.qp_iters)
    assert chol.factor_solve_launches == min(40, -(-iters // every) * every)

    arr = [torch.as_tensor(a, device=cuda) for a in fused_problem(4, 5)]
    with pytest.raises(TypeError, match="float32"):
        ipm.ipm_lsc_fused(*arr)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 64, 130, 1024])
def test_cholesky_batched_kernel_matches_plain(cuda, B):
    """The factor-only kernel against its plain version (cholesky_ex) in
    f32 and f64: f32 within 1e-4 relative of the f64 factor as the plain
    f32 one is, zeros above the diagonal, one launch; a non-SPD entry's
    lower triangle is NaN in both, and only that entry is."""
    Hs, _, _ = ipm_like_system(B, seed=B)
    bad = B // 2 if B > 1 else None
    if bad is not None:
        Hs[bad, 7, 7] = -1.0
    H64 = torch.as_tensor(Hs, device=cuda)
    L64 = chol.cholesky_batched_plain(H64)
    chol.reset_counts()
    Lk64 = chol.cholesky_batched(H64)
    Lk = chol.cholesky_batched(H64.float())
    torch.cuda.synchronize()
    assert chol.factor_launches == 2
    Lp = chol.cholesky_batched_plain(H64.float())
    for L in (Lk64, Lk, Lp):
        fin = torch.isfinite(L).all(-1).all(-1)
        assert (~fin).nonzero().flatten().tolist() == \
            ([] if bad is None else [bad])
        if bad is not None:
            assert torch.isnan(L[bad][torch.tril(
                torch.ones_like(L[bad], dtype=torch.bool))]).all()
        assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    ok = torch.arange(B, device=cuda) != bad
    torch.testing.assert_close(Lk64[ok], L64[ok], rtol=1e-12, atol=1e-12)
    e_k = (Lk[ok].double() - L64[ok]).abs().max().item()
    e_p = (Lp[ok].double() - L64[ok]).abs().max().item()
    assert e_k <= 4 * e_p + 1e-6, (e_k, e_p)


def bits(t):
    """t's bits as integers: torch.equal on them compares NaNs too."""
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [39, 64])
@pytest.mark.parametrize("B", [1, 64, 130, 1024])
def test_cholesky_batched_is_factor_solve_factor(cuda, B, n, dtype):
    """The factor alone runs factor_solve's kernel without its solve, so
    cholesky_batched(H) is chol_factor_solve(H, r)'s L bit for bit, a
    non-SPD entry's NaNs included (entry B // 2, inside a block of healthy
    ones; at B = 1 the only entry); one launch each.  At both register
    capacities (n = 39, 64) and B not a multiple of four (130)."""
    Hs, r1, _ = ipm_like_system(B, n, seed=300 + B + n)
    bad = B // 2
    Hs[bad, 7, 7] = -1.0
    H = torch.as_tensor(Hs, device=cuda, dtype=dtype)
    R = torch.as_tensor(r1, device=cuda, dtype=dtype)
    chol.reset_counts()
    F = chol.cholesky_batched(H)
    L = chol.chol_factor_solve(H, R)[0]
    torch.cuda.synchronize()
    assert (chol.factor_launches, chol.factor_solve_launches) == (1, 1)
    assert torch.equal(bits(F), bits(L))
    assert (~torch.isfinite(F).all(-1).all(-1)).nonzero().flatten() \
        .tolist() == [bad]
    assert torch.isnan(F[bad][torch.tril(torch.ones_like(
        F[bad], dtype=torch.bool))]).all()
    assert torch.equal(torch.triu(F, 1), torch.zeros_like(F))


def wavefront_case(shape, seed, fill=0.2, outside=False):
    """Random occupancy (f32, 1 = blocked) with an occupied goal for agent
    0 and goal cells (z, y, x) int32, on the CPU; with `outside`, agent 1's
    goal lies just past the grid's far x edge."""
    rng = np.random.default_rng(seed)
    N, Z, Y, X = shape
    occ = (rng.uniform(size=shape) < fill).astype(np.float32)
    goal = np.stack([rng.integers(0, Z, N), rng.integers(0, Y, N),
                     rng.integers(0, X, N)], -1).astype(np.int32)
    occ[0, goal[0, 0], goal[0, 1], goal[0, 2]] = 1.0
    if outside:
        goal[1, 2] = X
    return torch.as_tensor(occ), torch.as_tensor(goal)


def forest_static_case(device, seed=0):
    """forest20's static occupancy (radius + grid margin) for its 20 goals,
    at the kernel's (N, Z, Y, X) = (20, 11, 41, 41), and the cap 139."""
    from lsc_planner_tpu_torch import GoalMode, Param, missions
    from lsc_planner_tpu_torch.sim.simulator import SyncSimulator

    sim = SyncSimulator(forest_mission(missions, seed),
                        Param(goal_mode=GoalMode.PRIOR_BASED), device=device)
    grid = sim.goal_planner.grid_planner
    occ = grid.static_occupancy(0.15)[None].expand(sim.N, *grid.dims)
    goal = grid.to_cell(sim.desired_goal).flip(-1)
    return (occ.permute(0, 3, 2, 1).float().contiguous(), goal.int(),
            grid.max_wavefront_iters)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,max_iters", [
    ((3, 5, 21, 21), 70), ((3, 5, 21, 21), 8), ((4, 7, 13, 29), 13),
    ((20, 11, 41, 41), 139), ((2, 1, 1, 1), 8), ((3, 3, 9, 64), 40),
    ((3, 4, 11, 70), 13), ((3, 4, 11, 70), 200), ((1, 11, 61, 61), 199),
    ((4, 21, 121, 121), 394), ((3, 5, 21, 21), 0)])
def test_wavefront_kernel_bit_exact(cuda, shape, max_iters):
    """The kernel against its plain version on the card, bit for bit, the
    relaxation step counts included; also where the cap ends the loop, at
    X = 64 and 70 (one and two words a row), at (1, 11, 61, 61) and (4,
    21, 121, 121) with their grid planner caps int(1.5 (X + Y + Z)), and
    at max_iters 0."""
    occ, goal = wavefront_case(shape, seed=sum(shape) + max_iters)
    occ, goal = occ.to(cuda), goal.to(cuda)
    want, want_steps = wavefront.wavefront_batched_plain(occ, goal,
                                                         max_iters)
    wavefront.reset_counts()
    got, steps = wavefront.wavefront_batched_steps(occ, goal, max_iters)
    torch.cuda.synchronize()
    assert wavefront.wavefront_launches == 1
    assert torch.equal(got, want)
    assert torch.equal(steps, want_steps)


@pytest.mark.cuda
def test_wavefront_kernel_forest_fields(cuda):
    """forest20's static fields: bit-exact, converged below the cap, and
    the goal cells at 0; then the grid limit (the wrapper raises past the
    kernel's shared memory, ops/wavefront.py::smem_bytes)."""
    occ, goal, cap = forest_static_case(cuda)
    want, want_steps = wavefront.wavefront_batched_plain(occ, goal, cap)
    got, steps = wavefront.wavefront_batched_steps(occ, goal, cap)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(steps, want_steps)
    assert int(steps.max()) < cap
    g = goal.long()
    assert bool((got[torch.arange(20), g[:, 0], g[:, 1], g[:, 2]] == 0).all())
    # an empty (11, 61, 61) grid, which the first design refused, bit for
    # bit at its cap; the largest grid one block holds (3 x 3228 row
    # words) and a raise one row past it
    mid = torch.tensor([[0, 1613, 32]], dtype=torch.int32, device=cuda)
    for shape, at, cap in (((1, 11, 61, 61), goal[:1], 199),
                           ((1, 1, 3226, 64), mid, 16)):
        free = torch.zeros(shape, device=cuda)
        want, want_steps = wavefront.wavefront_batched_plain(free, at, cap)
        got, steps = wavefront.wavefront_batched_steps(free, at, cap)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(steps, want_steps)
    with pytest.raises(ValueError, match="shared memory"):
        wavefront.wavefront_batched(torch.zeros((1, 1, 3227, 64),
                                                device=cuda), goal[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,max_iters", [((3, 4, 11, 70), 13),
                                             ((3, 3, 9, 64), 0),
                                             ((3, 5, 21, 21), 70)])
def test_wavefront_kernel_goal_outside_the_grid(cuda, shape, max_iters):
    """Agent 1's goal lies outside the grid: its field is all BIG after 8
    steps (0 at max_iters 0), bit for bit with the plain version."""
    occ, goal = wavefront_case(shape, seed=7 + max_iters, outside=True)
    occ, goal = occ.to(cuda), goal.to(cuda)
    want, want_steps = wavefront.wavefront_batched_plain(occ, goal,
                                                         max_iters)
    got, steps = wavefront.wavefront_batched_steps(occ, goal, max_iters)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(steps, want_steps)
    assert bool((got[1] == wavefront.BIG).all())
    assert int(steps[1]) == (8 if max_iters > 0 else 0)


# ----------------------------------------------------------------------
# the corridor's face expansion, and several cycles a dispatch
# ----------------------------------------------------------------------
CORRIDOR_WORLD = (-3.0, -3.0, 0.0, 3.0, 3.0, 2.5)
FOREST20_WORLD = (-5.0, -5.0, 0.0, 5.0, 5.0, 2.5)


def shell_boxes(c=(0.0, 0.0, 1.25), h=0.6, t=0.1):
    """Six slabs of a hollow cube around c: inner half-size h, walls t."""
    c = np.asarray(c)
    out = []
    for a in range(3):
        for s in (-1.0, 1.0):
            lo, hi = c - h - t, c + h + t
            if s < 0:
                hi = hi.copy()
                hi[a] = c[a] - h
            else:
                lo = lo.copy()
                lo[a] = c[a] + h
            out.append(np.concatenate([lo, hi]))
    return np.stack(out)


def corridor_case(case, mis):
    """(world, obstacle boxes, seed points, goals) of a face-expansion
    case: random seeds in a 4-agent forest (some inside a tree's margin),
    an empty world, seeds boxed in by a hollow cube, seeds on the world
    minimum, and forest20's starts (toward their goals) with random seeds;
    random seeds in the 4-agent forest for N = 1, 33 and 130 agents
    (warps and blocks with ragged edges), a seed whose six faces all fail
    at their first try (a hollow cube of inner half-size 0.3 m), and seeds
    in an empty world that grow to its edges; `mis` is either package's
    missions module."""
    rng = np.random.default_rng(11)
    world = CORRIDOR_WORLD
    if case in ("n1", "n33", "n130"):
        m = forest_mission(mis, 3, 4, 12, world)
        boxes = np.stack([np.concatenate([o.pose - o.dimensions,
                                          o.pose + o.dimensions])
                          for o in m.obstacles])
        n = int(case[1:])
        pts = rng.uniform(world[:3], world[3:], size=(n, 3))
        goals = rng.uniform(world[:3], world[3:], size=(n, 3))
    elif case == "all_fail":
        boxes = shell_boxes(h=0.3)
        pts = np.array([[0.0, 0.0, 1.25], [0.03, -0.02, 1.27]])
        goals = np.array([[2.5, 2.5, 2.0], [-2.5, 0.0, 0.2]])
    elif case == "world_edge":
        boxes = np.zeros((0, 6))
        pts = np.array([[-2.9, -2.9, 0.1], [2.9, 2.9, 2.4],
                        [0.0, 0.0, 1.25]])
        goals = np.array([[2.9, 2.9, 2.4], [-2.9, -2.9, 0.1],
                          [1.0, 0.0, 1.0]])
    elif case in ("random", "forest20"):
        if case == "random":
            m = forest_mission(mis, 3, 4, 12, world)
        else:
            world = FOREST20_WORLD
            m = forest_mission(mis, 0)
        boxes = np.stack([np.concatenate([o.pose - o.dimensions,
                                          o.pose + o.dimensions])
                          for o in m.obstacles])
        pts = rng.uniform(world[:3], world[3:], size=(24, 3))
        goals = rng.uniform(world[:3], world[3:], size=(24, 3))
        if case == "forest20":
            pts = np.concatenate([[a.start for a in m.agents], pts])
            goals = np.concatenate([[a.goal for a in m.agents], goals])
    elif case == "empty":
        boxes = np.zeros((0, 6))
        pts = np.array([[0.0, 0.0, 1.0], [1.23, -0.77, 2.0]])
        goals = np.array([[2.0, 1.0, 1.0], [-3.0, 3.0, 0.0]])
    elif case == "boxed_in":
        boxes = shell_boxes()
        pts = np.array([[0.0, 0.0, 1.25], [0.05, -0.12, 1.3]])
        goals = np.array([[2.5, 2.5, 2.0], [-2.5, 0.0, 0.2]])
    else:                                   # seeds on the world minimum
        boxes = shell_boxes()
        pts = np.array([world[:3], [-3.0, 0.4, 1.0], [1.0, -3.0, 0.0]])
        goals = np.array([[0.0, 0.0, 1.0], [3.0, 0.0, 1.0],
                          [1.0, 3.0, 2.0]])
    return world, boxes, pts, goals


def corridor_args(case, dtype, device):
    """(CorridorBuilder, points, goals, expand_boxes's arguments) of a
    corridor_case on `device`."""
    from lsc_planner_tpu_torch import missions
    from lsc_planner_tpu_torch.world.corridor import CorridorBuilder
    from lsc_planner_tpu_torch.world.esdf import ESDF

    world, boxes, pts, goals = corridor_case(case, missions)
    esdf = ESDF.from_boxes(boxes, world[:3], world[3:], resolution=0.1,
                           dtype=dtype, device=device)
    b = CorridorBuilder(esdf, np.asarray(world[:3]), np.asarray(world[3:]),
                        0.15, dtype=dtype)
    p = torch.as_tensor(pts, dtype=dtype, device=device)
    g = torch.as_tensor(goals, dtype=dtype, device=device)
    lo, hi = b.initial_box(p)
    wmin, wmax = b._world_bounds(dtype)
    return b, p, g, (lo, hi, b._axis_order(lo, hi, g), ~b._obstructed(lo, hi),
                     b.sat, b._wmin32, wmin, wmax)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["random", "empty", "boxed_in",
                                  "world_min", "forest20", "n1", "n33",
                                  "n130", "all_fail", "world_edge"])
def test_corridor_kernel_matches_plain(cuda, case, dtype):
    """The face-expansion kernel against its plain version on the same
    card tensors, bit for bit, one launch; CorridorBuilder's metric boxes
    from it equal the plain version's.  "all_fail": the first seed's six
    faces all fail at their first try (its box stays), the second seed is
    obstructed; "world_edge": every box grows to the world's bounds."""
    from lsc_planner_tpu_torch import missions
    from lsc_planner_tpu_torch.world.corridor import CorridorBuilder
    from lsc_planner_tpu_torch.world.esdf import ESDF

    world, boxes, pts, goals = corridor_case(case, missions)
    esdf = ESDF.from_boxes(boxes, world[:3], world[3:], resolution=0.1,
                           dtype=dtype, device=cuda)
    b = CorridorBuilder(esdf, np.asarray(world[:3]), np.asarray(world[3:]),
                        0.15, dtype=dtype)
    p = torch.as_tensor(pts, dtype=dtype, device=cuda)
    g = torch.as_tensor(goals, dtype=dtype, device=cuda)
    lo, hi = b.initial_box(p)
    ok = ~b._obstructed(lo, hi)
    cand = b._axis_order(lo, hi, g)
    wmin, wmax = b._world_bounds(dtype)
    args = (lo, hi, cand, ok, b.sat, b._wmin32, wmin, wmax)
    want = corridor_ops.expand_boxes_plain(*args)
    corridor_ops.reset_counts()
    got = corridor_ops.expand_boxes(*args)
    torch.cuda.synchronize()
    assert corridor_ops.expand_launches == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(((want[1] - want[0]) >= (hi - lo)).all())
    bmin, bmax, seed_ok = b.expand_boxes(p, g)
    torch.cuda.synchronize()
    assert torch.equal(bmin, want[0].to(dtype) * 0.1)
    assert torch.equal(bmax, want[1].to(dtype) * 0.1)
    assert torch.equal(seed_ok, ok)
    if case == "all_fail":
        assert ok.tolist() == [True, False]
        assert torch.equal(got[0], lo) and torch.equal(got[1], hi)
    if case == "world_edge":
        w = torch.as_tensor(world, dtype=dtype, device=cuda)
        assert bool((bmin <= w[:3] + 0.1).all() and
                    (bmax >= w[3:] - 0.1).all()), (bmin, bmax)


# the kernel's builds: the tries a round it speculates (LSC_CORRIDOR_K),
# and the package's
CORRIDOR_KS = (1, 4, 6, 8)
CORRIDOR_K = 8


def corridor_build_launch(lib, args, stamps=None):
    """expand_boxes's arguments through a measurement build of the kernel
    (ops/_build.py::load_variant): its boxes, and each agent's stamps in
    the stamped build's."""
    sfx, eargs, got, _ins = corridor_ops.entry_args(*args)
    name = "lsc_expand_boxes_" + sfx
    if stamps is not None:
        name = "lsc_expand_boxes_stamped_" + sfx
        eargs = [*eargs, stamps.data_ptr()]
    assert _build.launch(getattr(lib, name), args[0].device, *eargs) == 0
    torch.cuda.synchronize()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["forest20", "n130", "world_min"])
def test_corridor_kernel_every_k(cuda, case, dtype):
    """Each build of the kernel (-DLSC_CORRIDOR_K=1, 4, 6 and 8 tries
    speculated a round) gives the plain version's boxes bit for bit, and
    the package's build takes CORRIDOR_K."""
    args = corridor_args(case, dtype, cuda)[3]
    want = corridor_ops.expand_boxes_plain(*args)
    assert corridor_ops.spec_k() == CORRIDOR_K
    for k in CORRIDOR_KS:
        lib = _build.load_variant(["corridor.cu"],
                                  [f"LSC_CORRIDOR_K={k}"])[0]
        assert corridor_ops.spec_k(lib) == k
        got = corridor_build_launch(lib, args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), k


@pytest.mark.cuda
def test_corridor_stamped_build_matches(cuda):
    """The stamped measurement build (-DLSC_CORRIDOR_STAMPS) gives the
    plain version's boxes at every K, and its stamps count the plain
    round-robin's tries."""
    args = corridor_args("forest20", torch.float32, cuda)[3]
    want = corridor_ops.expand_boxes_plain(*args)
    tries = None
    for k in CORRIDOR_KS:
        lib = _build.load_variant(["corridor.cu"], [
            "LSC_CORRIDOR_STAMPS", f"LSC_CORRIDOR_K={k}"])[0]
        st = torch.zeros(args[0].shape[0], 4, dtype=torch.int64,
                         device=cuda)
        got = corridor_build_launch(lib, args, st)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        tries = int(st[:, 0].sum()) if tries is None else tries
        assert int(st[:, 0].sum()) == tries, k
        assert bool((st[:, 1] * k >= st[:, 0]).all()), k


def state_bit_diffs(a, b):
    """Differing elements, field by field, of two SwarmStates (floats by
    their bits, so NaNs compare too)."""
    out = {}
    for f, x, y in zip(a._fields, a, b):
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        if x.is_floating_point():
            x, y = bits(x), bits(y)
        out[f] = int((x != y).sum())
    return out


def captured_against_uncaptured(sim, before, k=10, blocks=1):
    """From the state after `before` cycles: `blocks` replays of k
    captured cycles (each replay fed the state the last returned, as
    run() does) against the same cycles uncaptured.  Returns (differing
    elements a field after each block, the captured block's launches,
    the counters' increase over the replays)."""
    from lsc_planner_tpu_torch.sim import simulator as sim_mod

    state = sim.initial_state()
    for _ in range(before):
        state, _ = sim.cycle(state)
    want, wants = state, []
    for _ in range(blocks):
        for _ in range(k):
            want, _ = sim.cycle(want)
        wants.append(want)
    multi = sim.make_scan_cycle(k)
    got, diffs = state, []
    got, _ = multi(got)
    torch.cuda.synchronize()
    graph = multi.graph
    diffs.append(state_bit_diffs(got, wants[0]))
    counts = sim_mod.launch_counts()
    for w in wants[1:]:
        got, _ = multi(got)
        torch.cuda.synchronize()
        diffs.append(state_bit_diffs(got, w))
    after = sim_mod.launch_counts()
    return diffs, graph.launches, {n: after[n] - counts[n] for n in after}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["circle64", "circle130_all_pairs",
                                  "forest20", "forest20_castray",
                                  "forest20_velocity"])
def test_captured_cycles_are_bit_equal(cuda, case):
    """10 cycles captured in one CUDA graph and replayed equal 10
    uncaptured cycles in every SwarmState field, bit for bit: circle64
    (dense rows on the chol kernels; two blocks, the second fed the
    first's output), a 130-agent all-pairs circle after 5 cycles (the
    fused IPM) and forest20 (grid planner, wavefront, corridor, chol),
    also with the exact castRay and with the VELOCITY prediction's
    slow-down against the ESDF.  The launch counters record the captured
    block (one LSC planes launch a cycle) and do not move on a replay."""
    from lsc_planner_tpu_torch import (GoalMode, Param, PredictionMode,
                                       make_circle_mission, missions)
    from lsc_planner_tpu_torch.sim.simulator import SyncSimulator

    def circle(qn):         # chip_smoke.py's circle swap (bench.py:65-71)
        r = max(4.0, 0.45 * qn / np.pi)
        return make_circle_mission(qn, radius=r, world=(-r - 2, -r - 2, 0,
                                                        r + 2, r + 2, 2.5))
    p = Param(goal_mode=GoalMode.PRIOR_BASED)
    if case == "circle64":
        m, before, blocks = circle(64), 3, 2
    elif case == "circle130_all_pairs":
        m, before, blocks = circle(130), 5, 1
    else:
        m, before, blocks = forest_mission(missions, 0), 3, 1
        p.grid_los_exact_castray = case == "forest20_castray"
        p.world_use_octomap = case == "forest20_velocity"
    sim = SyncSimulator(m, p, device=cuda)
    if case == "forest20_velocity":
        sim.param.prediction_mode = PredictionMode.VELOCITY
    diffs, launches, moved = captured_against_uncaptured(sim, before,
                                                         blocks=blocks)
    for d in diffs:
        assert not any(d.values()), d
    assert not any(moved.values()), moved
    if case == "circle130_all_pairs":
        assert launches["fused_ipm"] == 10
        assert launches["factor_solve"] == launches["resolve"] == 0
    else:
        assert launches["factor_solve"] == 10 * p.qp_iterations
        assert launches["resolve"] == 10 * p.qp_iterations * \
            (1 + p.qp_correctors)
    if case.startswith("forest20"):
        assert launches["wavefront"] == 20 and launches["expand_boxes"] == 10
    assert launches["lsc_planes"] == 10


def factored_problem(rng, N, C, dtype, device):
    """(args, keywords) of a factored-row QP solve (qp.solve_qp_lsc) with
    Param's shapes, random SPD cost blocks and planes, a warm start, the
    blocked static rows, and production tolerances (40 iterations at most,
    one Gondzio corrector)."""
    from lsc_planner_tpu_torch.config import Param
    from lsc_planner_tpu_torch.planner.optimizer import TrajOptimizer

    opt = TrajOptimizer(Param())
    nv, nf, M, n1 = opt.nv, opt.nf, opt.M, opt.n + 1
    Lb = rng.normal(size=(N, nf, nf)) * 0.3
    P_blk = Lb @ np.swapaxes(Lb, -1, -2) + 2.0 * np.eye(nf)
    P = np.zeros((N, nv, nv))
    for k in range(3):
        P[:, k * nf:(k + 1) * nf, k * nf:(k + 1) * nf] = P_blk
    args = [P, rng.normal(size=(N, nv)), opt.A_static_y,
            rng.normal(size=(N, opt.A_static_y.shape[0])) - 5.0,
            rng.normal(size=(N, C, M, 3)),
            rng.normal(size=(N, C, M, n1)) - 3.0,
            rng.uniform(size=(N, C, M, n1)) > 0.3, opt.F_seg]
    args = [torch.as_tensor(np.asarray(a), device=device) for a in args]
    args = [a.to(dtype) if a.is_floating_point() else a for a in args]
    kw = dict(y0=torch.as_tensor(rng.normal(size=(N, nv)) * 0.1,
                                 dtype=dtype, device=device),
              iters=40, tol_gap=1e-6, tol_rp=1e-4, tol_rd=0.2, correctors=1,
              static_blocks=opt.static_blocked_on(dtype, device))
    return args, kw


@pytest.mark.cuda
def test_ipm_exit_read_is_skipped_under_capture(cuda):
    """The factored path inside a CUDA graph: the capture succeeds (no host
    read), runs all 40 iterations (40 factor_solve launches captured) and
    replays to the bits of the uncaptured solve, which exits early.  The
    duality-gap tolerance is 1e-3, not factored_problem's 1e-6: at 1e-6
    the uncaptured solve of this problem runs all 40 iterations, and the
    early exit would go untested."""
    args, kw = factored_problem(np.random.default_rng(5), 16, 5,
                                torch.float32, cuda)
    kw["tol_gap"] = 1e-3
    chol.reset_counts()
    ref = qp.solve_qp_lsc(*args, **kw)
    torch.cuda.synchronize()
    eager = chol.factor_solve_launches
    assert 1 < int(ref.iters) < 40 and eager < 40
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qp.solve_qp_lsc(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    chol.reset_counts()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = qp.solve_qp_lsc(*args, **kw)
    assert chol.factor_solve_launches == 40
    g.replay()
    torch.cuda.synchronize()
    for f, a, b in zip(ref._fields, got, ref):
        if a is None:
            assert b is None, f
            continue
        if a.is_floating_point():
            a, b = bits(a), bits(b)
        assert torch.equal(a, b), f


@pytest.mark.cuda
@pytest.mark.parametrize("mode,noise", [("PREVIOUS_SOLUTION", 0.0),
                                        ("VELOCITY", 0.0), ("ORACLE", 0.0),
                                        ("LINEAR_KALMAN_FILTER", 0.02)])
def test_dynamic_obstacle_cycles_on_the_card_match_the_cpu(cuda, mode,
                                                          noise):
    """tests/test_dynamic_obstacles.py's 2-agent mission with a spinning,
    a straight and a chasing obstacle, 10 cycles of run() in f64 under
    each prediction mode: the card's trajectories within 1e-6 m of the
    CPU's (the host obstacle step, its copies to the card and, for the
    chasing obstacle, its read of the agents' positions)."""
    from lsc_planner_tpu_torch import (AgentSpec, GoalMode, Mission,
                                       ObstacleSpec, Param, PredictionMode)
    from lsc_planner_tpu_torch.sim.simulator import SyncSimulator

    def mission():
        agents = []
        for qi, (s, g) in enumerate([((-3.0, 0.5, 1.0), (3.0, 0.5, 1.0)),
                                     ((3.0, -0.5, 1.0), (-3.0, -0.5, 1.0))]):
            a = AgentSpec(id=qi, cid=qi + 1)
            a.start, a.goal = np.asarray(s), np.asarray(g)
            agents.append(a)
        return Mission(
            world_min=np.array([-5.0, -5, 0]),
            world_max=np.array([5.0, 5, 2.5]), agents=agents,
            obstacles=[
                ObstacleSpec(kind="spin", size=0.3, max_acc=2.0,
                             axis_position=np.array([0.0, 2.0, 1.0]),
                             axis_ori=np.array([0.0, 0.0, 1.0]),
                             start=np.array([0.0, 3.0, 1.0]), speed=0.5),
                ObstacleSpec(kind="straight", size=0.25, max_acc=1.0,
                             start=np.array([0.0, -3.0, 1.0]),
                             goal=np.array([0.0, 3.0, 1.0]), speed=0.2),
                ObstacleSpec(kind="chasing", size=0.2, max_acc=1.0,
                             start=np.array([1.0, 2.5, 1.0]), max_vel=0.4,
                             gamma_target=0.5, gamma_obs=1.0)][
                :2 if mode == "ORACLE" else 3])

    trajs = []
    for device in (cuda, torch.device("cpu")):
        p = Param(goal_mode=GoalMode.STATIC, qp_iterations=12,
                  obs_observer_stddev=noise)
        sim = SyncSimulator(mission(), p, device=device, dtype=torch.float64)
        sim.param.prediction_mode = PredictionMode[mode]
        out, cycle = [], sim.cycle

        def rec(state, *dyn):
            new = cycle(state, *dyn)
            out.append(new[0].traj.cpu())
            return new
        sim.cycle = rec
        sim.run(max_iterations=10)
        trajs.append(torch.stack(out))
    assert trajs[0].shape == trajs[1].shape == (10, 2, 5, 6, 3)
    assert (trajs[0] - trajs[1]).abs().max().item() <= 1e-6


def big_spd_system(B, n, seed, dev):
    """ipm_like_system at a large n, built on the card in f64 (numpy's
    three-operand einsum takes minutes there): (Hs, r1, r2)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn(B, 3 * n, n, generator=g, device=dev,
                    dtype=torch.float64)
    d = torch.exp(torch.empty(B, 3 * n, device=dev, dtype=torch.float64
                              ).uniform_(-np.log(1e3), np.log(1e3),
                                         generator=g))
    H = torch.eye(n, device=dev, dtype=torch.float64) + \
        A.mT @ (A * d[..., None])
    dsc = torch.rsqrt(torch.diagonal(H, dim1=-2, dim2=-1))
    Hs = H * dsc[:, :, None] * dsc[:, None, :]
    r = torch.randn(2, B, n, generator=g, device=dev, dtype=torch.float64)
    return Hs, r[0], r[1]


LARGE_COUNTERS = {"cluster": ("factor_solve_cluster_launches",
                              "resolve_cluster_launches",
                              "factor_cluster_launches"),
                  "tiled": ("factor_solve_tiled_launches",
                            "resolve_tiled_launches",
                            "factor_tiled_launches")}


def large_counts():
    """{design: (factor_solve, resolve, factor) launches} of the large-n
    kernels, and the one-warp kernels' under None."""
    out = {d: tuple(getattr(chol, c) for c in cs)
           for d, cs in LARGE_COUNTERS.items()}
    out[None] = (chol.factor_solve_launches, chol.resolve_launches,
                 chol.factor_launches)
    return out


def check_large_chol(dev, B, n, dtype):
    """factor_solve, resolve and the factor alone of the large-n design
    the plan picks, on an IPM-like system: each against the f64 solve (f32:
    within 4x the plain f32 version's error + 1e-6; f64: rtol 1e-9),
    resolve(L, rhs) factor_solve's x bit for bit, the factor alone
    factor_solve's L bit for bit with zeros above the diagonal, the
    launches on the counters of the design that ran, and (B > 1) a
    non-SPD entry NaN in that entry only, the others unchanged."""
    ran = chol.large_design(n, dtype)
    H64, R1d, R2d = big_spd_system(B, n, seed=n + B, dev=dev)
    L64, x64 = chol.chol_factor_solve_plain(H64, R1d)
    y64 = chol.chol_resolve_plain(L64, R2d)
    H, R1, R2 = H64.to(dtype), R1d.to(dtype), R2d.to(dtype)
    chol.reset_counts()
    Lk, xk = chol.chol_factor_solve(H, R1)
    yk = chol.chol_resolve(Lk, R2)
    xr = chol.chol_resolve(Lk, R1)
    Fk = chol.cholesky_batched(H)
    torch.cuda.synchronize()
    want = {d: (0, 0, 0) for d in (None, "cluster", "tiled")}
    want[ran] = (1, 2, 1)
    assert large_counts() == want
    L2, x2 = chol.chol_factor_solve(H, R1)       # a second launch
    assert torch.equal(bits(L2), bits(Lk))
    assert torch.equal(bits(x2), bits(xk))
    assert torch.equal(xr, xk)
    assert torch.equal(Fk, Lk)
    assert torch.equal(torch.triu(Lk, 1), torch.zeros_like(Lk))
    for got, ref, plain in ((xk, x64, lambda: chol.chol_factor_solve_plain(
                                H, R1)[1]),
                            (yk, y64, lambda: chol.chol_resolve_plain(
                                chol.chol_factor_solve_plain(H, R1)[0], R2))):
        if dtype == torch.float64:
            torch.testing.assert_close(got, ref, rtol=1e-9, atol=1e-9)
        else:
            e_k = (got.double() - ref).abs().max().item()
            e_p = (plain().double() - ref).abs().max().item()
            assert e_k <= 4 * e_p + 1e-6, (e_k, e_p)
    if B > 1:
        bad = B // 2
        Hb = H.clone()
        Hb[bad, 7, 7] = -1.0
        Lb, xb = chol.chol_factor_solve(Hb, R1)
        yb = chol.chol_resolve(Lb, R2)
        Fb = chol.cholesky_batched(Hb)
        torch.cuda.synchronize()
        for v in (xb, yb):
            assert (~torch.isfinite(v).all(-1)).nonzero().flatten(
                ).tolist() == [bad]
        low = torch.tril(torch.ones_like(Lb[bad], dtype=torch.bool))
        assert torch.isnan(Lb[bad][low]).all()
        assert torch.equal(Fb.view(-1).isnan(), Lb.view(-1).isnan())
        ok = torch.arange(B, device=dev) != bad
        assert torch.equal(Lb[ok], Lk[ok]) and torch.equal(xb[ok], xk[ok])
        assert torch.equal(yb[ok], yk[ok])
    return ran


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B, n", [(1, 65), (7, 96), (64, 354), (3, 399),
                                  (2, 1024)])
def test_large_n_chol_kernels(cuda, B, n, dtype):
    """Past 64 the chol kernels run one cluster a matrix where a cluster
    of one or two blocks holds the factor (chol.large_plan), else the tiled
    design: held as check_large_chol holds them, on the counters of the
    design the plan picks."""
    ran = check_large_chol(cuda, B, n, dtype)
    assert ran == ("cluster" if chol.large_plan(n, dtype) else "tiled")


# n at the edges of each cluster size G (chol.large_plan): f32 G = 1 up to
# 288, 2 up to 384; f64 G = 1 up to 192, 2 up to 256; and the slack QP's
# 359 and 365
CLUSTER_EDGES = {torch.float32: (65, 199, 200, 288, 289, 359, 365, 384),
                 torch.float64: (65, 192, 193, 199, 200, 256)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n", [(d, n) for d, ns in CLUSTER_EDGES.items()
                                     for n in ns])
def test_cluster_chol_kernels_at_plan_edges(cuda, dtype, n):
    """The cluster kernels at the edges of each cluster size, B = 3 (a
    non-SPD entry in the middle one)."""
    assert check_large_chol(cuda, 3, n, dtype) == "cluster"


# the tiled design's shapes: past the clusters (f32 n > 384, f64 n > 256),
# the slack QP's n at 96 agents (525) and, in f64, at 64 (365), and past
# the first design's cap of 1024
TILED_CASES = [(torch.float32, n) for n in (385, 399, 525, 641, 1024, 1100,
                                            1536)] + \
    [(torch.float64, n) for n in (257, 365, 385, 1024, 1100)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n", TILED_CASES)
def test_block_chol_kernels_past_the_clusters(cuda, dtype, n):
    """Where no cluster of the plan's sizes holds the factor, the tiled
    design runs (and holds, check_large_chol: a second launch the same
    bits, resolve factor_solve's x and the factor alone its L bit for bit,
    a non-SPD entry NaN in that entry only) by the plan."""
    assert chol.large_plan(n, dtype) is None
    assert check_large_chol(cuda, 3, n, dtype) == "tiled"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [385, 525, 1100, 1536, chol.MAX_N])
def test_tiled_task_order_matches_the_mirror(cuda, n):
    """csrc/chol_tiled.cuh's task order (task_of, read back through
    lsc_chol_tiled_task) is chol.tiled_task's at every task, and its
    workspace chol.tiled_work_ints'."""
    import ctypes

    from lsc_planner_tpu_torch.ops import _build

    lib = _build.load_library()
    out = (ctypes.c_int * 3)()
    for B in (1, 3):
        assert lib.lsc_chol_tiled_work(n, B) == chol.tiled_work_ints(n, B)
        total = lib.lsc_chol_tiled_task(n, B, 0, out)
        assert total == B * (len(chol.tiled_tasks(n)) + 1)
        for t in range(total):
            lib.lsc_chol_tiled_task(n, B, t, out)
            assert tuple(out) == chol.tiled_task(t, n, B), (n, B, t)


@pytest.mark.cuda
def test_cluster_plan_matches_the_kernels(cuda):
    """csrc/chol.cu's cluster_plan and chol.large_plan agree at every n
    and both element sizes, and the factor's shared memory fits a
    block."""
    import ctypes

    from lsc_planner_tpu_torch.ops import _build

    lib = _build.load_library()
    out = (ctypes.c_longlong * 3)()
    for dtype, elem in ((torch.float32, 4), (torch.float64, 8)):
        for n in range(1, chol.MAX_N + 1):
            lib.lsc_chol_cluster_plan(n, elem, out)
            plan = chol.large_plan(n, dtype)
            assert (out[0], out[1]) == (plan or (0, 0)), (n, dtype)
            assert out[1] <= chol.SMEM_CAP and out[2] <= out[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n", [(torch.float32, 365),
                                     (torch.float64, 250)] + TILED_CASES)
def test_large_chol_captured_is_bit_equal(cuda, dtype, n):
    """factor_solve and two resolves captured in one CUDA graph and
    replayed give the uncaptured launches' bits (the cluster kernels at
    365 and 250, the tiled design at TILED_CASES)."""
    H64, R1d, R2d = big_spd_system(16, n, seed=n, dev=cuda)
    H, R1, R2 = H64.to(dtype), R1d.to(dtype), R2d.to(dtype)

    def calls():
        L, x = chol.chol_factor_solve(H, R1)
        return L, x, chol.chol_resolve(L, R2), chol.chol_resolve(L, R1)
    want = calls()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = calls()
    graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[3], got[1])


@pytest.mark.cuda
def test_chol_kernels_refuse_past_the_cap(cuda):
    H = torch.eye(chol.MAX_N + 1, device=cuda)[None]
    with pytest.raises(ValueError, match="MAX_N"):
        chol.chol_factor_solve(H, torch.zeros(1, chol.MAX_N + 1,
                                              device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("B,C", [(1, 5), (128, 128), (130, 32)])
def test_fused_kernel_2d_matches_plain(cuda, B, C):
    """The 2-D instantiation (nv = 26) against the plain version as in
    test_fused_kernel_matches_plain."""
    arr = fused_problem(B, C, seed=B + C, dim=2)
    a64 = [torch.as_tensor(a, device=cuda) for a in arr]
    a32 = [a.float() for a in a64]
    for kw in (dict(iters=3, tol_gap=0.0, tol_rp=0.0, correctors=1),
               PROD_TOL):
        ref = ipm.ipm_lsc_fused_plain(*a64, **kw)
        plain = ipm.ipm_lsc_fused_plain(*a32, **kw)
        ipm.reset_counts()
        got = ipm.ipm_lsc_fused(*a32, **kw)
        torch.cuda.synchronize()
        assert ipm.fused_launches == 1
        assert got[0].shape == (B, 26) and got[1].shape == ref[1].shape
        e_k = (got[0].double() - ref[0]).abs().max().item()
        e_p = (plain[0].double() - ref[0]).abs().max().item()
        assert e_k <= 4 * e_p + 1e-4, (kw["iters"], e_k, e_p)
        assert (got[4] - plain[4]).abs().max().item() <= 1
        for t in got[:4]:
            assert torch.isfinite(t).all()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["rsfc", "2d"])
def test_captured_mode_cycles_are_bit_equal(cuda, mode):
    """4 captured cycles equal 4 uncaptured ones bit for bit: an 8-agent
    circle under RECIPROCAL_RSFC (the slack QP at n = 45 + 7 x 5 = 80 on
    the large-n chol kernels, a cluster of one block a matrix; no LSC
    planes) and a 130-agent 2-D circle (the fused IPM at ndim 2, one LSC
    planes launch a cycle)."""
    from lsc_planner_tpu_torch import (GoalMode, Param, PlannerMode,
                                       make_circle_mission)
    from lsc_planner_tpu_torch.sim.simulator import SyncSimulator

    if mode == "rsfc":
        qn, p = 8, Param(planner_mode=PlannerMode.RECIPROCAL_RSFC,
                         goal_mode=GoalMode.PRIOR_BASED)
    else:
        qn, p = 130, Param(world_dimension=2, world_z_2d=1.0,
                           goal_mode=GoalMode.PRIOR_BASED)
    r = max(4.0, 0.45 * qn / np.pi)
    m = make_circle_mission(qn, radius=r, z=1.0,
                            world=(-r - 2, -r - 2, 0, r + 2, r + 2, 2.5))
    sim = SyncSimulator(m, p, device=cuda)
    diffs, launches, moved = captured_against_uncaptured(sim, 3, k=4)
    for d in diffs:
        assert not any(d.values()), d
    assert not any(moved.values()), moved
    if mode == "rsfc":
        assert launches["factor_solve_cluster"] == 4 * p.qp_iterations
        assert launches["factor_solve"] == 0
        assert launches["factor_solve_tiled"] == 0
        assert launches["lsc_planes"] == 0
    else:
        assert launches["fused_ipm"] == 4
        assert launches["lsc_planes"] == 4


def orca_inputs(N, dtype, device, seed=0):
    """A swarm of N agents as dense as the 64-agent circle's crossing
    (about 1.3 agents a square metre), random velocities and preferred
    velocities: orca_velocities' arguments."""
    rng = np.random.default_rng(seed)
    half = 0.5 * np.sqrt(N / 1.3)
    pos = rng.uniform(-half, half, (N, 3))
    pos[:, 2] = rng.uniform(0.5, 1.5, N)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    return (t(pos), t(rng.uniform(-1, 1, (N, 3))), t(np.full(N, 0.15 * 1.5)),
            t(rng.uniform(-1, 1, (N, 3))), t(np.full(N, 1.0)),
            torch.as_tensor(rng.random(N) < 0.1, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("force_z_zero", [False, True])
def test_orca_velocities_card_matches_cpu(cuda, dtype, tol, force_z_zero):
    """ORCA velocities of 1024 agents on the card equal the same call on
    the CPU within 1e-5 m/s in f32 and 1e-12 in f64, in 3-D and with the
    2-D pinning planes; lp4 runs for some agents."""
    from lsc_planner_tpu_torch.ops import orca

    args = orca_inputs(1024, dtype, cuda)
    got = orca.orca_velocities(*args, 2.0, 0.5, force_z_zero=force_z_zero)
    want = orca.orca_velocities(*[a.cpu() for a in args], 2.0, 0.5,
                                force_z_zero=force_z_zero)
    assert got.dtype == dtype and got.device.type == "cuda"
    assert (got.cpu() - want).abs().max().item() <= tol
    nbr_d2, nbr = orca.neighbours(args[0].cpu(), 10)
    planes = orca.build_orca_planes(
        args[0].cpu(), args[1].cpu(), args[2].cpu(), args[0].cpu()[nbr],
        args[1].cpu()[nbr], args[2].cpu()[nbr], args[5].cpu()[nbr],
        nbr_d2 < 225.0, 2.0, 0.5)
    fail, _ = orca._lp3(planes, args[4].cpu(), args[3].cpu(), False)
    assert (fail < 10).any()


@pytest.mark.cuda
@pytest.mark.parametrize("goal_mode,dim", [("STATIC", 3), ("ORCA", 3),
                                           ("STATIC", 2)])
def test_captured_orca_cycles_are_bit_equal(cuda, goal_mode, dim):
    """10 captured ORCA cycles (the rotational exchange of 64 agents)
    equal 10 uncaptured ones bit for bit in every SwarmState field, with
    the static and the ORCA goal modes and in a 2-D world; no kernel is
    launched."""
    from lsc_planner_tpu_torch import (GoalMode, Param, PlannerMode,
                                       make_circle_mission)
    from lsc_planner_tpu_torch.sim.simulator import SyncSimulator

    qn = 64
    r = max(4.0, 0.45 * qn / np.pi)
    m = make_circle_mission(qn, radius=r, z=1.0,
                            world=(-r - 2, -r - 2, 0, r + 2, r + 2, 2.5))
    starts = [a.start for a in m.agents]
    for qi, a in enumerate(m.agents):
        a.goal = starts[(qi + qn // 3) % qn].copy()
    kw = dict(world_dimension=2, world_z_2d=1.0) if dim == 2 else {}
    p = Param(planner_mode=PlannerMode.ORCA,
              goal_mode=GoalMode[goal_mode], **kw)
    sim = SyncSimulator(m, p, device=cuda)
    diffs, launches, moved = captured_against_uncaptured(sim, 20)
    for d in diffs:
        assert not any(d.values()), d
    assert not any(launches.values()), launches
    assert not any(moved.values()), moved


@pytest.mark.cuda
def test_continuous_audit_card_matches_cpu(cuda):
    """continuous_safety_ratio of 64 random continuous trajectories on the
    card equals the CPU's within 1e-6 (f32) and never exceeds a dense
    sampled audit of the same trajectories by more than 1e-4."""
    from lsc_planner_tpu_torch.sim import audit

    rng = np.random.default_rng(3)
    N, M, n = 64, 5, 5
    base = rng.uniform(-4, 4, (N, 1, 1, 3))
    tr = base + np.cumsum(rng.normal(size=(N, M, n + 1, 3)) * 0.05, axis=-2)
    tr[:, 1:, 0] = tr[:, :-1, -1]
    radius, downwash = np.full(N, 0.15), np.full(N, 2.0)

    def on(dev):
        return [torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in (tr, radius, downwash)]
    got = audit.continuous_safety_ratio(*on(cuda)).item()
    want = audit.continuous_safety_ratio(*on("cpu")).item()
    assert abs(got - want) <= 1e-6
    ts = np.linspace(0.0, M * 0.2, 1001)[:-1]
    pos = audit.positions_at(on(cuda)[0], ts, 0.2)
    sampled = audit.pairwise_safety_ratio(pos, *on(cuda)[1:]).min().item()
    assert got <= sampled + 1e-4


def _group_of_one(backend):
    """A process group of one rank in this process (file store in a
    temporary directory); the caller destroys it."""
    import os
    import tempfile

    import torch.distributed as dist
    tmp = tempfile.mkdtemp()
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "store"),
        world_size=1, rank=0)
    return dist


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
@pytest.mark.parametrize("qn,K", [(64, -1), (130, 32)])
def test_sharded_world_of_one_equals_single_cycle_bits(cuda, backend, qn,
                                                       K):
    """chip_smoke's 17a at a small size: a world of one rank on nccl (and
    on gloo, which stages the exchange through host buffers), 3 cycles
    through make_sharded_cycle, each equal to sim.cycle from the same
    state bit for bit in traj, through the chol kernels (64 agents) and
    the fused IPM (130 agents, K = 32)."""
    from lsc_planner_tpu_torch import GoalMode, Param, make_circle_mission
    from lsc_planner_tpu_torch.parallel import shard
    from lsc_planner_tpu_torch.sim.simulator import SyncSimulator

    r = max(4.0, 0.45 * qn / np.pi)
    m = make_circle_mission(qn, radius=r,
                            world=(-r - 2, -r - 2, 0, r + 2, r + 2, 2.5))
    sim = SyncSimulator(m, Param(goal_mode=GoalMode.PRIOR_BASED,
                                 max_neighbors=K), device=cuda)
    dist = _group_of_one(backend)
    try:
        cycle = shard.make_sharded_cycle(sim, shard.make_mesh(device=cuda))
        state = cycle.shard(sim.initial_state())
        for _ in range(3):
            nxt, info = cycle(state)
            ref, _ = sim.cycle(state)
            assert torch.equal(nxt.traj, ref.traj)
            assert torch.equal(nxt.pos, ref.pos)
            safety, failed, _ = cycle.stats(nxt, info).tolist()
            assert safety >= 1.0 and failed == 0
            state = nxt
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_refuses_two_ranks_a_card(cuda):
    """spawn_ranks refuses nccl with more ranks than cards before it
    starts any."""
    from lsc_planner_tpu_torch.parallel import ranks
    from lsc_planner_tpu_torch.parallel.launch import spawn_ranks
    with pytest.raises(RuntimeError, match="one card a rank"):
        spawn_ranks(ranks.dryrun_rank, torch.cuda.device_count() + 1,
                    "nccl")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 2e-4)])
def test_geometry_and_fista_card_match_cpu(cuda, dtype, tol):
    """The collision-geometry helpers and the hull's FISTA branch (K = 12)
    on the card against the same calls on the CPU."""
    from lsc_planner_tpu_torch.ops import geometry as geo
    from lsc_planner_tpu_torch.ops import hull

    rng = np.random.default_rng(5)
    n = 256
    start = rng.normal(size=(n, 3)) * 2.0
    goal = start + rng.normal(size=(n, 3)) * 3.0
    centre = rng.normal(size=(n, 3))
    half = rng.uniform(0.2, 1.5, size=(n, 3))
    radius = rng.uniform(0.1, 0.6, size=n)
    dirn = rng.normal(size=(n, 3))
    dirn /= np.linalg.norm(dirn, axis=-1, keepdims=True)
    obs = start[:, None] + rng.normal(size=(n, 5, 3)) * 2.0
    orad = rng.uniform(0.1, 0.4, size=(n, 5))
    boxes = np.concatenate([centre[:6] - half[:6], centre[:6] + half[:6]],
                           axis=-1)
    pts = rng.normal(size=(64, 12, 3)) + 1.5

    def run(dev):
        t = [torch.as_tensor(a, dtype=dtype, device=dev)
             for a in (start, goal, centre - half, centre + half, radius,
                       dirn, obs, orad, boxes, pts)]
        s, g, lo, hi, r, d, o, orr, bx, p = t
        out = {"ellipsoidal": geo.ellipsoidal_distance(s, g, r + 1.0),
               "transform": geo.downwash_transform(s, r + 1.0),
               "pair_downwash": geo.pair_downwash(r, r + 1, r.flip(0),
                                                  r.flip(0) + 1),
               "point_box": geo.point_box_distance(s, lo, hi),
               "segments": torch.stack(geo.closest_between_segments(
                   s, g, lo, hi)[:2]),
               "segment_box": geo.segment_box_distance(s, g, lo, hi),
               "collision": geo.segment_box_collision(s, g, lo, hi, r),
               "time": geo.box_collision_time(s, g, lo, hi, r, 2.0),
               "safe": geo.safe_dist_in_direction(s, d, o, orr, r,
                                                  boxes=bx),
               "fista": torch.cat(hull.closest_point_to_hull(p)[:1])}
        return {k: v.cpu() for k, v in out.items()}

    got, want = run(cuda), run("cpu")
    for k in want:
        # a sphere grazing a box within rounding may flip one verdict
        if want[k].dtype == torch.bool:
            assert (got[k] != want[k]).sum() <= 1, k
            continue
        finite = torch.isfinite(want[k]) & torch.isfinite(got[k])
        assert (torch.isfinite(want[k]) != torch.isfinite(got[k])).sum() \
            <= 1, k
        scale = max(1.0, float(want[k][finite].abs().max()))
        assert float((got[k][finite] - want[k][finite]).abs().max()) <= \
            tol * scale, k


# ------------------------------------------------------------ LSC planes
def degenerate_hulls(rng, K, big):
    """Relative control-point hulls (H, K, 3) that stress the enumeration
    of ops/hull.py::_closest_point_enum: every point the same, collinear
    points, the origin inside (the interior test's +x fallback, K > 3),
    equal-distance ties between subsets (duplicated points, a mirrored
    pair), every point at the origin, a line through the origin, a hull
    closer than the normal's eps, a tiny hull far out, axis-aligned points
    with signed zeros, points whose Gram entries overflow (`big`: every
    subset infeasible, so the first candidate is taken) and a NaN point."""
    p = rng.normal(size=3) * 2.0
    d = rng.normal(size=3)
    t = rng.uniform(-1.0, 1.0, size=K)
    inside = rng.normal(size=(K, 3))
    inside -= inside.mean(0)
    pair = np.array([[1.0, 0.5, 0.0], [1.0, -0.5, 0.0]])
    ties = np.resize(np.concatenate([pair, pair[:1]]), (K, 3))
    axis = np.resize(np.array([[2.0, 0.0, -0.0], [2.0, -0.0, 0.0],
                               [3.0, 0.0, 0.0]]), (K, 3))
    nan = rng.normal(size=(K, 3))
    nan[K // 2, 1] = np.nan
    return np.stack([
        np.repeat(p[None], K, 0), p + t[:, None] * d, inside, ties,
        np.zeros((K, 3)), t[:, None] * d, inside * 1e-12 + 1e-11,
        p + rng.normal(size=(K, 3)) * 1e-6, axis, -axis,
        rng.normal(size=(K, 3)) * big, nan])


def lsc_planes_case(case, shape, dtype, device, seed=0):
    """(arguments, keyword arguments) of lsc_planes at shape (N, O, M, K):
    "random", trajectories of a swarm at about 0.5 agents a cubic metre,
    each agent's obstacles the predictions of random others (a tenth of
    them its own, so hulls hold the origin), random radii, downwash,
    agent flags and masks; "guard", the same with a guard band that
    clamps at both ends; "slack", the same with slack flags and RSFC sizes;
    "degenerate", degenerate_hulls and random hulls in turn (zero
    trajectories against the negated hulls at downwash 1, so the relative
    points are the hulls exactly)."""
    N, O, M, K = shape
    rng = np.random.default_rng(seed)
    kw = {}
    if case == "degenerate":
        big = 1e25 if dtype == torch.float32 else 1e160
        hulls = degenerate_hulls(rng, K, big)
        H = N * O * M
        rel = rng.normal(size=(H, K, 3))
        idx = np.arange(0, H, 2)
        rel[idx] = hulls[idx // 2 % len(hulls)]
        init = np.zeros((N, M, K, 3))
        obs = -rel.reshape(N, O, M, K, 3)
        ar, adw = np.full(N, 0.15), np.ones(N)
        orad, odw = np.full((N, O), 0.15), np.ones((N, O))
    else:
        side = max(2.0, (N / 0.5) ** (1.0 / 3.0))
        pos = rng.uniform(0.0, side, size=(N, 1, 1, 3))
        steps = rng.normal(size=(N, M * K, 3)) * 0.05
        init = pos + np.cumsum(steps, axis=1).reshape(N, M, K, 3)
        other = rng.integers(0, N, size=(N, O))
        own = rng.uniform(size=(N, O)) < 0.1
        other = np.where(own, np.arange(N)[:, None], other)
        obs = init[other] + rng.normal(size=(N, O, M, K, 3)) * 0.02
        ar = 0.15 + rng.uniform(0.0, 0.05, size=N)
        adw = rng.uniform(1.5, 2.5, size=N)
        orad = 0.15 + rng.uniform(0.0, 0.05, size=(N, O))
        odw = rng.uniform(1.5, 2.5, size=(N, O))
        if case == "guard":
            kw["guard_margin"] = 0.04
        if case == "slack":
            kw["guard_margin"] = 0.004
            kw["slack_flags"] = torch.as_tensor(
                rng.uniform(size=(N, O)) < 0.5, device=device)
            kw["obs_pred_sizes"] = torch.as_tensor(
                rng.uniform(0.1, 0.4, size=(N, O, M, K)), dtype=dtype,
                device=device)
    is_agent = rng.uniform(size=(N, O)) < 0.8
    mask = rng.uniform(size=(N, O)) < 0.9

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)
    args = (t(init), t(obs), t(ar), t(adw), t(orad), t(odw),
            t(is_agent, torch.bool), t(mask, torch.bool))
    return args, kw


def same_bits(a, b):
    """a and b bit for bit, NaNs compared as NaN (their payloads are not
    the function's)."""
    return bool(((bits(a) == bits(b)) | (a.isnan() & b.isnan())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case,shape", [
    ("random", (64, 32, 5, 6)), ("guard", (64, 32, 5, 6)),
    ("slack", (64, 32, 5, 6)), ("degenerate", (8, 16, 5, 6)),
    ("random", (1024, 32, 5, 6)), ("random", (20, 19, 5, 6)),
    ("random", (20, 20, 5, 6)), ("degenerate", (5, 7, 3, 4)),
    ("random", (3, 5, 2, 1)), ("random", (3, 5, 2, 2)),
    ("random", (3, 5, 2, 3)), ("degenerate", (3, 5, 2, 3)),
    ("random", (33, 9, 4, 5)), ("random", (33, 9, 4, 7)),
    ("degenerate", (6, 9, 4, 8)), ("guard", (1, 1, 1, 6))])
def test_lsc_planes_kernel_matches_plain(cuda, case, shape, dtype):
    """The LSC planes kernel against its plain version on the same card
    tensors, bit for bit (normals and right-hand sides), in one launch:
    random swarms (the benchmark cells' shapes among them), the guard band,
    the slack branch, degenerate hulls, and every hull size 1 to 8."""
    from lsc_planner_tpu_torch.ops import lsc_planes as lsc_ops

    args, kw = lsc_planes_case(case, shape, dtype, cuda, seed=sum(shape))
    lsc_ops.reset_counts()
    got = lsc_ops.lsc_planes(*args, **kw)
    want = lsc_ops.lsc_planes_plain(*args, **kw)
    torch.cuda.synchronize()
    assert lsc_ops.lsc_planes_launches == 1
    assert same_bits(got.normal, want.normal)
    assert same_bits(got.rhs, want.rhs)
    assert torch.equal(got.mask, want.mask)
    if case == "degenerate":         # the +x fallback and the overflow
        assert bool((want.normal[..., 0] == 1.0).any())
        assert bool(torch.isnan(want.rhs).any())


@pytest.mark.cuda
def test_lsc_planes_kernel_refuses_and_routes(cuda):
    """A dtype the kernel lacks raises; hulls of more than 8 points run the
    plain version (FISTA) on the card, with no launch."""
    from lsc_planner_tpu_torch.ops import lsc_planes as lsc_ops

    args, kw = lsc_planes_case("random", (4, 3, 2, 6), torch.float32, cuda)
    with pytest.raises(ValueError, match="dtype"):
        lsc_ops.lsc_planes(*[a.half() if a.is_floating_point() else a
                             for a in args])
    args, kw = lsc_planes_case("random", (4, 3, 2, 9), torch.float32, cuda)
    lsc_ops.reset_counts()
    got = lsc_ops.lsc_planes(*args)
    want = lsc_ops.lsc_planes_plain(*args)
    assert lsc_ops.lsc_planes_launches == 0
    assert same_bits(got.rhs, want.rhs)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["circle130_knn", "forest20"])
def test_captured_cycles_with_the_planes_kernel_equal_plain(cuda, case,
                                                            monkeypatch):
    """10 cycles captured in one CUDA graph, through the LSC planes kernel,
    equal 10 uncaptured cycles with constraints.lsc_planes replaced by the
    plain version, bit for bit in every SwarmState field: a 130-agent
    circle with K-NN pruning (K = 32, the fused IPM) and forest20 (all
    pairs, the chol path).  One planes launch a cycle (one an LSC
    plan_block)."""
    from lsc_planner_tpu_torch import (GoalMode, Param, make_circle_mission,
                                       missions)
    from lsc_planner_tpu_torch.ops import lsc_planes as lsc_ops
    from lsc_planner_tpu_torch.planner import constraints as cons
    from lsc_planner_tpu_torch.sim.simulator import SyncSimulator

    if case == "circle130_knn":
        qn = 130
        r = max(4.0, 0.45 * qn / np.pi)
        m = make_circle_mission(qn, radius=r, world=(-r - 2, -r - 2, 0,
                                                     r + 2, r + 2, 2.5))
        p = Param(goal_mode=GoalMode.PRIOR_BASED, max_neighbors=32)
        before = 5
    else:
        m, before = forest_mission(missions, 0), 3
        p = Param(goal_mode=GoalMode.PRIOR_BASED)
    sim = SyncSimulator(m, p, device=cuda)
    state = sim.initial_state()
    for _ in range(before):
        state, _ = sim.cycle(state)
    with monkeypatch.context() as mp:
        mp.setattr(cons, "lsc_planes", lsc_ops.lsc_planes_plain)
        want = state
        for _ in range(10):
            want, _ = sim.cycle(want)
    multi = sim.make_scan_cycle(10)
    got, _ = multi(state)
    torch.cuda.synchronize()
    diffs = state_bit_diffs(got, want)
    assert not any(diffs.values()), diffs
    assert multi.graph.launches["lsc_planes"] == 10
