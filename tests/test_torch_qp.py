"""Port parity: the IPM QP solver and the optimizer's tables.

Stated tolerances: optimizer tables equal; solve_qp and the non-fused
solve_qp_lsc with tolerances 0 and a fixed iteration count: y max abs
<= 1e-7 (f64).  With the production tolerances the port's early exit
must report the JAX iteration count.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_planner_tpu.config import Param
from lsc_planner_tpu.ops import qp as jqp
from lsc_planner_tpu.planner.optimizer import TrajOptimizer as JOpt
from lsc_planner_tpu_torch.ops import qp as tqp
from lsc_planner_tpu_torch.planner.optimizer import TrajOptimizer as TOpt

Y_TOL = 1e-7


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------- tables
TABLES = ["F", "G", "Q_full", "FQF", "FQ", "endpoint_rows", "F_seg",
          "y_extract_idx", "A_static_y", "_static_b_index"]


@pytest.mark.parametrize("name", TABLES)
@pytest.mark.parametrize("kw", [{}, {"n": 7, "phi": 4, "dt": 0.25}])
def test_optimizer_tables_equal(name, kw):
    j, t = JOpt(Param(**kw)), TOpt(Param(**kw))
    a, b = getattr(j, name), getattr(t, name)
    for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_static_rows_and_blocks_equal():
    j, t = JOpt(Param()), TOpt(Param())
    np.testing.assert_array_equal(j.static_rows[0], t.static_rows[0])
    assert j.static_rows[1] == t.static_rows[1]
    for x, y in zip(j.static_blocked, t.static_blocked):
        np.testing.assert_array_equal(x, y)


def test_fused_mode_validated():
    with pytest.raises(ValueError, match="qp_fused_mode"):
        TOpt(Param(qp_fused_mode="interpret"))
    with pytest.raises(ValueError, match="fused_mode"):
        tqp.solve_qp_lsc(*[None] * 8, fused_mode="interpret")


# ---------------------------------------------------------------- solvers
def _known_qp(rng, B=6, nv=12, nr=30, n_active=5):
    Ps, qs, As, bs = [], [], [], []
    for _ in range(B):
        L = rng.normal(size=(nv, nv))
        P = L @ L.T + nv * np.eye(nv)
        A = rng.normal(size=(nr, nv))
        y = rng.normal(size=nv)
        lam = np.zeros(nr)
        lam[:n_active] = rng.uniform(0.5, 2.0, size=n_active)
        b = A @ y
        b[n_active:] -= rng.uniform(0.5, 3.0, size=nr - n_active)
        Ps.append(P), qs.append(A.T @ lam - P @ y), As.append(A)
        bs.append(b)
    return [np.stack(v) for v in (Ps, qs, As, bs)]


@pytest.mark.parametrize("warm,masked,corr", [
    (False, False, 0), (True, False, 1), (True, True, 1), (False, True, 1),
])
def test_solve_qp_matches(rng, warm, masked, corr):
    P, q, A, b = _known_qp(rng)
    kw_j, kw_t = {}, {}
    if warm:
        y0 = rng.normal(size=q.shape) * 0.1
        kw_j["y0"], kw_t["y0"] = jnp.asarray(y0), _t(y0)
    if masked:
        mask = rng.uniform(size=b.shape) > 0.2
        kw_j["mask"], kw_t["mask"] = jnp.asarray(mask), _t(mask)
    j = jqp.solve_qp(jnp.asarray(P), jnp.asarray(q), jnp.asarray(A),
                     jnp.asarray(b), iters=18, correctors=corr, **kw_j)
    t = tqp.solve_qp(_t(P), _t(q), _t(A), _t(b), iters=18,
                     correctors=corr, **kw_t)
    assert np.abs(t.y.numpy() - np.asarray(j.y)).max() <= Y_TOL
    np.testing.assert_allclose(t.obj.numpy(), np.asarray(j.obj), rtol=1e-9)
    np.testing.assert_allclose(t.gap.numpy(), np.asarray(j.gap), rtol=1e-6,
                               atol=1e-12)
    assert int(t.iters) == int(j.iters) == 18


def _lsc_problem(rng, N=3, C=5, dtype=np.float64):
    opt = JOpt(Param())
    nv, nf = opt.nv, opt.nf
    M, n1 = opt.M, opt.n + 1
    Lb = rng.normal(size=(N, nf, nf)) * 0.3
    P_blk = Lb @ np.swapaxes(Lb, -1, -2) + 2.0 * np.eye(nf)
    P = np.zeros((N, nv, nv))
    for k in range(3):
        P[:, k * nf:(k + 1) * nf, k * nf:(k + 1) * nf] = P_blk
    arrays = dict(
        P=P, q=rng.normal(size=(N, nv)), A_st=opt.A_static_y,
        b_st=rng.normal(size=(N, opt.A_static_y.shape[0])) - 5.0,
        normal=rng.normal(size=(N, C, M, 3)),
        rhs=rng.normal(size=(N, C, M, n1)) - 3.0,
        mask=rng.uniform(size=(N, C, M, n1)) > 0.3, F_seg=opt.F_seg)
    arrays = {k: (v.astype(dtype) if v.dtype == np.float64 else v)
              for k, v in arrays.items()}
    y0 = (rng.normal(size=(N, nv)) * 0.1).astype(dtype)
    return opt, arrays, P_blk.astype(dtype), y0


@pytest.mark.parametrize("blocked,warm,corr", [
    (False, False, 0), (True, False, 1), (True, True, 1), (False, True, 1),
])
def test_solve_qp_lsc_matches(rng, blocked, warm, corr):
    opt, arr, P_blk, y0 = _lsc_problem(rng)
    kw = dict(iters=16, tol_gap=0.0, tol_rp=0.0, correctors=corr)
    if blocked:
        kw["static_blocks"] = opt.static_blocked
    names = ["P", "q", "A_st", "b_st", "normal", "rhs", "mask", "F_seg"]
    j = jqp.solve_qp_lsc(*[jnp.asarray(arr[k]) for k in names],
                         y0=jnp.asarray(y0) if warm else None, **kw)
    t = tqp.solve_qp_lsc(*[_t(arr[k]) for k in names],
                         y0=_t(y0) if warm else None,
                         P_blk=_t(P_blk), fused_mode="auto", **kw)
    assert np.abs(t.y.numpy() - np.asarray(j.y)).max() <= Y_TOL
    np.testing.assert_allclose(t.obj.numpy(), np.asarray(j.obj), rtol=1e-9)
    np.testing.assert_allclose(t.primal_res.numpy(),
                               np.asarray(j.primal_res), atol=1e-9)
    assert int(t.iters) == int(j.iters) == 16
    if warm:
        np.testing.assert_allclose(t.warm_res.numpy(),
                                   np.asarray(j.warm_res), atol=1e-12)
        np.testing.assert_array_equal(t.warm_row.numpy(),
                                      np.asarray(j.warm_row))


@pytest.mark.parametrize("tol_step", [0.0, 1e-3])
def test_solve_qp_lsc_early_exit_reports_jax_iters(rng, tol_step):
    """Production tolerances: the port checks the exit only every few
    iterations, yet latched instances freeze, so y and the reported
    iteration count equal the JAX while_loop's."""
    opt, arr, _, y0 = _lsc_problem(rng, N=4)
    names = ["P", "q", "A_st", "b_st", "normal", "rhs", "mask", "F_seg"]
    kw = dict(iters=40, tol_gap=1e-6, tol_rp=1e-4, tol_rd=0.2,
              tol_step=tol_step, correctors=1,
              static_blocks=opt.static_blocked)
    j = jqp.solve_qp_lsc(*[jnp.asarray(arr[k]) for k in names],
                         y0=jnp.asarray(y0), **kw)
    t = tqp.solve_qp_lsc(*[_t(arr[k]) for k in names], y0=_t(y0), **kw)
    assert 1 < int(j.iters) < 40
    assert int(t.iters) == int(j.iters)
    assert np.abs(t.y.numpy() - np.asarray(j.y)).max() <= Y_TOL


def test_violation_report():
    A = _t(np.eye(4)[None])
    b = _t(np.array([0.0, 2.0, -1.0, 5.0])[None])
    vals, idx = tqp.violation_report(A, b, torch.zeros((1, 4),
                                                       dtype=A.dtype),
                                     top_k=2)
    assert idx[0].tolist() == [3, 1] and vals[0].tolist() == [5.0, 2.0]
