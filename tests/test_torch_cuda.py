"""CUDA kernel checks for the port (skip without a GPU).

These tests import no JAX, so they also run on a machine without it:
    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from lsc_planner_tpu_torch.ops import chol, qp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU with "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py")
    return torch.device("cuda")


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


@pytest.mark.cuda
def test_fused_dispatch_raises_and_off_runs(cuda):
    """At N >= 128 under "auto" the fused IPM kernel would run on the
    card; it is not ported, so the cycle raises.  "off" keeps the JAX
    meaning and solves through the factored rows and the chol kernels."""
    from lsc_planner_tpu_torch import GoalMode, Param, make_circle_mission
    from lsc_planner_tpu_torch.sim.simulator import SyncSimulator

    mission = make_circle_mission(128, radius=18.4,
                                  world=(-20.4, -20.4, 0, 20.4, 20.4, 2.5))
    sim = SyncSimulator(mission, Param(goal_mode=GoalMode.PRIOR_BASED),
                        device=cuda)
    with pytest.raises(NotImplementedError, match="fused IPM kernel"):
        sim.cycle(sim.initial_state())
    sim = SyncSimulator(mission, Param(goal_mode=GoalMode.PRIOR_BASED,
                                       qp_fused_mode="off"), device=cuda)
    chol.reset_counts()
    state, info = sim.cycle(sim.initial_state())
    torch.cuda.synchronize()
    assert torch.isfinite(state.traj).all()
    assert not bool(info.qp_failed.any())
    # the early exit is checked every EXIT_CHECK_EVERY iterations
    every = qp.EXIT_CHECK_EVERY
    iters = int(info.qp_iters)
    assert chol.factor_solve_launches == min(40, -(-iters // every) * every)
