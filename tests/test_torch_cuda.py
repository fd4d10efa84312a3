"""CUDA kernel checks for the port (skip without a GPU).

These tests import no JAX, so they also run on a machine without it:
    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from lsc_planner_tpu_torch.ops import chol, ipm, qp, wavefront


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
@pytest.mark.parametrize("B", [1, 64, 130])
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


def fused_problem(B, C, seed=0):
    """Inputs of ``ipm.ipm_lsc_fused`` on the production row structure
    (the optimizer's unit-norm U and F_seg), built as tests/test_qp.py:
    169-181 builds its QPs: P_blk = L L' + 2 I, about 70 % of the plane
    rows live.  Every bound is negative, so the start d = 0 is strictly
    feasible and each QP has a solution however many rows it has.  float64
    numpy arrays in the wrapper's argument order."""
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
    return [P_blk, q, y0, U, b_pairs, nsc, scale, b_pl, F_seg, sigma]


PROD_TOL = dict(iters=40, tol_gap=1e-3, tol_rp=1e-4, tol_rd=0.2,
                tol_step=1e-3, correctors=1)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 64, 1024])
@pytest.mark.parametrize("C", [5, 32, 64])
def test_fused_kernel_matches_plain(cuda, B, C):
    """The kernel against its plain version in f32 on the card, both held
    to an f64 plain run: the kernel's y error within 4x the plain f32
    error + 1e-4, the same tile iteration counts within 1."""
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
    kernel (one launch, no chol launch), here with K-NN pruning (K = 32);
    all-pairs rows at 128 agents (C = 128) are more than the kernel's
    shared memory holds and raise.  "off" keeps the JAX meaning and solves
    through the factored rows and the chol kernels.  An unsupported dtype
    raises on the card."""
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
    with pytest.raises(NotImplementedError, match="C = 128"):
        sim.cycle(sim.initial_state())

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
@pytest.mark.parametrize("B", [1, 64, 130])
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


def wavefront_case(shape, seed, fill=0.2):
    """Random occupancy (f32, 1 = blocked) with an occupied goal for agent
    0 and goal cells (z, y, x) int32, on the CPU."""
    rng = np.random.default_rng(seed)
    N, Z, Y, X = shape
    occ = (rng.uniform(size=shape) < fill).astype(np.float32)
    goal = np.stack([rng.integers(0, Z, N), rng.integers(0, Y, N),
                     rng.integers(0, X, N)], -1).astype(np.int32)
    occ[0, goal[0, 0], goal[0, 1], goal[0, 2]] = 1.0
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
    ((20, 11, 41, 41), 139), ((2, 1, 1, 1), 8)])
def test_wavefront_kernel_bit_exact(cuda, shape, max_iters):
    """The kernel against its plain version on the card, bit for bit, the
    relaxation step counts included; also where the cap ends the loop."""
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
    the goal cells at 0."""
    occ, goal, cap = forest_static_case(cuda)
    want, want_steps = wavefront.wavefront_batched_plain(occ, goal, cap)
    got, steps = wavefront.wavefront_batched_steps(occ, goal, cap)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(steps, want_steps)
    assert int(steps.max()) < cap
    g = goal.long()
    assert bool((got[torch.arange(20), g[:, 0], g[:, 1], g[:, 2]] == 0).all())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        wavefront.wavefront_batched(torch.zeros((1, 11, 61, 61),
                                                device=cuda), goal[:1])
