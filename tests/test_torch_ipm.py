"""Port parity: the fused whole-IPM solve (ops/ipm.py) and the fused branch
of solve_qp_lsc, against the JAX package's Pallas kernel in interpret mode.

The oracle is the TPU kernel itself, not the port's non-fused ``_ipm``: the
fused kernel floors its pivots, forces its scaled diagonal, tests its exit
on the new iterate and reports tile counts (see ops/ipm.py).  Inputs are
float32 (the kernel is float32 only), N = 5, C = 5.  Stated tolerances:
  * 3 iterations, tolerances off: y, lam_s, lam_p, gap within rtol 1e-3,
    atol 1e-4 (f32 summation order over three iterations), equal counts;
  * 15 iterations, tolerances off: test_qp.py:198-204's contract -- y rtol
    5e-3 / atol 1e-2 (a near-flat direction), obj rtol 1e-3, gap rtol 0.1,
    primal residual < 1e-4;
  * production tolerances: the tile iteration count within 1 of JAX's and
    y within the same contract.
Each JAX interpret-mode signature compiles for ~20 s on a CPU, so the JAX
runs are shared through one module-scoped cache.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_planner_tpu.config import Param
from lsc_planner_tpu.ops import qp as jqp
from lsc_planner_tpu.ops.ipm_pallas import ipm_lsc_fused as jax_fused
from lsc_planner_tpu.planner.optimizer import TrajOptimizer as JOpt
from lsc_planner_tpu_torch.ops import ipm
from lsc_planner_tpu_torch.ops import qp as tqp
from test_torch_cuda import PROD_TOL, fused_problem

OFF3 = dict(iters=3, tol_gap=0.0, tol_rp=0.0, correctors=1)
OFF15 = dict(iters=15, tol_gap=0.0, tol_rp=0.0, correctors=1)
CASES = {"off3": OFF3, "off15": OFF15, "prod": PROD_TOL}


def _problem(nonspd=False, wide=False):
    """N = 5, C = 5; wide: N = 3, C = 70 (more row groups than one CUDA
    block's shared memory holds for four QPs)."""
    if wide:
        return [a.astype(np.float32) for a in fused_problem(3, 70, seed=12)]
    arr = [a.astype(np.float32) for a in fused_problem(5, 5, seed=11)]
    if nonspd:
        # an indefinite cost block: QP 2's Jacobi-scaled Gram is not SPD and
        # its factor hits the 1e-6 pivot floor
        nf = arr[0].shape[-1]
        arr[0][2] = 100.0 * np.ones((nf, nf), np.float32) - \
            50.0 * np.eye(nf, dtype=np.float32)
    return arr


@pytest.fixture(scope="module")
def jax_run():
    cache = {}

    def run(case, nonspd=False, wide=False):
        key = (case, nonspd, wide)
        if key not in cache:
            out = jax_fused(*[jnp.asarray(a) for a in _problem(nonspd, wide)],
                            interpret=True, block_b=8, **CASES[case])
            cache[key] = [np.asarray(x) for x in out]
        return cache[key]
    return run


def _port(case, nonspd=False, wide=False):
    out = ipm.ipm_lsc_fused(*[torch.as_tensor(a)
                              for a in _problem(nonspd, wide)],
                            **CASES[case])
    return [x.numpy() for x in out]


def _obj_and_primal(arr, y):
    """Objective 0.5 y'Py + q'y and max constraint violation of the fused
    problem at y, in float64 numpy."""
    P_blk, q, _, U, b_pairs, nsc, scale, b_pl, F_seg, _ = \
        [np.asarray(a, np.float64) for a in arr]
    y = np.asarray(y, np.float64)
    N, nf = P_blk.shape[0], P_blk.shape[-1]
    y3 = y.reshape(N, 3, nf)
    obj = 0.5 * np.einsum("nkf,nfg,nkg->n", y3, P_blk, y3) + (q * y).sum(-1)
    su = np.einsum("kuf,nkf->nku", U, y3).reshape(N, -1)
    x = np.einsum("mif,nkf->nkmi", F_seg, y3)
    pl = np.einsum("ncmk,nkmi->ncmi", nsc, x) * scale
    viol = np.concatenate([b_pairs[:, 0] - su, b_pairs[:, 1] + su,
                           (b_pl - pl).reshape(N, -1)], axis=1)
    return obj, np.maximum(viol.max(-1), 0.0)


def test_fused_plain_matches_jax_fixed_iters(jax_run):
    j, t = jax_run("off3"), _port("off3")
    for name, a, b in zip(("y", "lam_s", "lam_p", "gap"), t[:4], j[:4]):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(t[4], j[4].astype(np.int32))
    assert t[4].tolist() == [3] * 5


def test_fused_plain_matches_jax_contract(jax_run):
    j, t = jax_run("off15"), _port("off15")
    arr = _problem()
    np.testing.assert_allclose(t[0], j[0], rtol=5e-3, atol=1e-2)
    obj_t, pr_t = _obj_and_primal(arr, t[0])
    obj_j, pr_j = _obj_and_primal(arr, j[0])
    np.testing.assert_allclose(obj_t, obj_j, rtol=1e-3)
    np.testing.assert_allclose(t[3], j[3], rtol=0.1, atol=1e-4)
    assert pr_t.max() < 1e-4 and pr_j.max() < 1e-4
    assert t[4].tolist() == [15] * 5


@pytest.mark.parametrize("case", ["off3", "prod"])
def test_fused_plain_matches_jax_wide_rows(jax_run, case):
    """C = 70 row groups (all-pairs rows of a 71-agent swarm): the plain
    version against the TPU kernel in interpret mode with the tolerances
    of the C = 5 cases above (off3: rtol 1e-3 / atol 1e-4 and equal
    counts; production: y's contract, counts within 1, primal < 1e-4)."""
    j, t = jax_run(case, wide=True), _port(case, wide=True)
    if case == "off3":
        for name, a, b in zip(("y", "lam_s", "lam_p", "gap"), t[:4], j[:4]):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4,
                                       err_msg=name)
        np.testing.assert_array_equal(t[4], j[4].astype(np.int32))
    else:
        assert 1 < int(j[4][0]) < PROD_TOL["iters"]
        assert np.abs(t[4] - j[4]).max() <= 1
        np.testing.assert_allclose(t[0], j[0], rtol=5e-3, atol=1e-2)
        assert _obj_and_primal(_problem(wide=True), t[0])[1].max() < 1e-4
    assert t[2].shape == (3, 70 * 5 * 6)


def test_fused_qp_counts_tile_to_the_reported_counts():
    """qp_counts=True gives each QP's own iteration count: the same
    solution, and the tile maximum of those counts is the default count."""
    arr = [torch.as_tensor(a) for a in _problem()]
    tile = ipm.ipm_lsc_fused(*arr, **PROD_TOL)
    own = ipm.ipm_lsc_fused(*arr, **PROD_TOL, qp_counts=True)
    for a, b in zip(tile[:4], own[:4]):
        assert torch.equal(a, b)
    assert torch.equal(ipm.tile_counts(own[4]), tile[4])
    assert bool((own[4] >= 1).all()) and bool((own[4] <= tile[4]).all())
    assert own[4].tolist() != tile[4].tolist()      # the QPs differ here
    off = ipm.ipm_lsc_fused(*arr, **OFF3, qp_counts=True)
    assert off[4].tolist() == [3] * 5


def test_fused_plain_matches_jax_production(jax_run):
    j, t = jax_run("prod"), _port("prod")
    assert 1 < int(j[4][0]) < PROD_TOL["iters"]
    assert np.abs(t[4] - j[4]).max() <= 1
    np.testing.assert_allclose(t[0], j[0], rtol=5e-3, atol=1e-2)
    assert _obj_and_primal(_problem(), t[0])[1].max() < 1e-4


def test_fused_plain_nonspd_gram_stays_finite(jax_run):
    j, t = jax_run("off3", nonspd=True), _port("off3", nonspd=True)
    for a, b in zip(t[:4], j[:4]):
        assert np.isfinite(a).all() and np.isfinite(b).all()
    np.testing.assert_allclose(t[0], j[0], rtol=5e-3, atol=1e-2)
    # the other QPs solve as in the batch without the indefinite block
    clean = _port("off3")
    keep = np.arange(5) != 2
    np.testing.assert_array_equal(t[0][keep], clean[0][keep])


@pytest.mark.parametrize("case", ["off15", "prod"])
def test_solve_qp_lsc_fused_on_matches_jax_interpret(rng, case):
    """The fused branch of solve_qp_lsc ("on" on a CPU tensor runs the plain
    version) against JAX's fused_mode="interpret": b_pairs from row_perm,
    the delta-coordinate call, primal_res, the dual reordering, obj and
    the warm-start diagnostics.  Tolerances off, 15 iterations: the
    contract of test_qp.py:198-204 (obj rtol 1e-3); production tolerances:
    an early-exit iterate is only gap-optimal, so y's contract and the
    iteration count within 1 hold there, and obj is not compared."""
    opt = JOpt(Param())
    nv, nf = opt.nv, opt.nf
    N, C, M, n1 = 4, 5, opt.M, opt.n + 1
    Lb = rng.normal(size=(N, nf, nf)) * 0.3
    P_blk = (Lb @ np.swapaxes(Lb, -1, -2) + 2.0 * np.eye(nf)).astype(
        np.float32)
    P = np.zeros((N, nv, nv), np.float32)
    for k in range(3):
        P[:, k * nf:(k + 1) * nf, k * nf:(k + 1) * nf] = P_blk
    arrays = [P, rng.normal(size=(N, nv)).astype(np.float32),
              opt.A_static_y.astype(np.float32),
              (rng.normal(size=(N, opt.A_static_y.shape[0])) - 5.0).astype(
                  np.float32),
              rng.normal(size=(N, C, M, 3)).astype(np.float32),
              (rng.normal(size=(N, C, M, n1)) - 3.0).astype(np.float32),
              rng.uniform(size=(N, C, M, n1)) > 0.3,
              opt.F_seg.astype(np.float32)]
    y0 = (rng.normal(size=(N, nv)) * 0.1).astype(np.float32)
    kw = dict(static_blocks=opt.static_blocked, **CASES[case])
    j = jqp.solve_qp_lsc(*[jnp.asarray(a) for a in arrays],
                         y0=jnp.asarray(y0), P_blk=jnp.asarray(P_blk),
                         fused_mode="interpret", **kw)
    ipm.reset_counts()
    t = tqp.solve_qp_lsc(*[torch.as_tensor(a) for a in arrays],
                         y0=torch.as_tensor(y0), P_blk=torch.as_tensor(P_blk),
                         fused_mode="on", **kw)
    assert ipm.fused_launches == 0          # the plain version never counts
    np.testing.assert_allclose(t.y.numpy(), np.asarray(j.y), rtol=5e-3,
                               atol=1e-2)
    assert t.primal_res.numpy().max() < 1e-4
    np.testing.assert_allclose(t.primal_res.numpy(),
                               np.asarray(j.primal_res), atol=1e-4)
    np.testing.assert_allclose(t.warm_res.numpy(), np.asarray(j.warm_res),
                               atol=1e-5)
    np.testing.assert_array_equal(t.warm_row.numpy(), np.asarray(j.warm_row))
    assert t.lam.shape == j.lam.shape
    assert np.abs(t.iters.numpy() - np.asarray(j.iters)).max() <= 1
    if case == "off15":
        # rtol 1e-3 of the batch's objective scale: one instance's optimum
        # lies near obj = 0, where its O(1) terms cancel
        j_obj = np.asarray(j.obj)
        np.testing.assert_allclose(t.obj.numpy(), j_obj, rtol=1e-3,
                                   atol=1e-3 * np.abs(j_obj).max())
        np.testing.assert_allclose(t.gap.numpy(), np.asarray(j.gap),
                                   rtol=0.1, atol=1e-4)
        # duals of the replicated LSC rows are not unique (test_qp.py:205-
        # 220): hold their sign and the strongly active set, which also
        # checks that the duals come back in the original row order
        lam_t, lam_j = t.lam.numpy(), np.asarray(j.lam)
        assert (lam_t > -1e-6).all()
        thr = 10.0 * max(float(t.gap.max()), float(np.max(j.gap)), 1e-6)
        assert ((lam_t > thr) ^ (lam_j > thr)).sum() <= 0.02 * lam_t.size


def test_fused_wrapper_guards():
    arr = [torch.as_tensor(a, dtype=torch.float32)
           for a in fused_problem(3, 5)]
    with pytest.raises(TypeError, match="float32"):
        ipm.ipm_lsc_fused(*[a.double() for a in arr])
    # the 2-D layout (U (2, Ru, nf), nsc (.., 2), q and y0 (N, 2 nf),
    # b_pairs (N, 2, 2 Ru)) solves
    nf, Ru = arr[0].shape[-1], arr[3].shape[1]
    two_d = list(arr)
    two_d[1], two_d[2] = arr[1][:, :2 * nf], arr[2][:, :2 * nf]
    two_d[3] = arr[3][:2]
    two_d[4] = arr[4][..., :2 * Ru]
    two_d[5] = arr[5][..., :2]
    out = ipm.ipm_lsc_fused(*two_d, iters=3, tol_gap=0.0, tol_rp=0.0)
    assert out[0].shape == (3, 2 * nf) and out[1].shape == (3, 2, 2 * Ru)
    for t in out[:4]:
        assert torch.isfinite(t).all()
    with pytest.raises(ValueError, match="dimension"):
        ipm.ipm_lsc_fused(*two_d[:3], arr[3][:1], *two_d[4:])
    # any number of row groups: C = 65 (once refused) solves
    wide = [torch.as_tensor(a, dtype=torch.float32)
            for a in fused_problem(2, 65)]
    out = ipm.ipm_lsc_fused(*wide, iters=3, tol_gap=0.0, tol_rp=0.0)
    assert out[2].shape == (2, 65 * 5 * 6)
    for t in out[:4]:
        assert torch.isfinite(t).all()
    # a CUDA tensor with no card: the kernel loader raises, no fallback
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ipm._fused_cuda(*arr, iters=3, reg=1e-8, s_min=1.0, tol_gap=0.0,
                            tol_rp=0.0, tol_rd=0.0, tol_step=0.0,
                            correctors=0)
    meta = [torch.empty(a.shape, device="meta") for a in arr]
    with pytest.raises(RuntimeError, match="no kernel"):
        ipm.ipm_lsc_fused(*meta)


def test_tile_counts():
    per_qp = torch.tensor([3] * 100 + [7] + [2] * 50 + [5] * 149,
                          dtype=torch.int32)
    got = ipm.tile_counts(per_qp)
    assert got.shape == (300,) and got.dtype == torch.int32
    assert got[:128].tolist() == [7] * 128
    assert got[128:256].tolist() == [5] * 128
    assert got[256:].tolist() == [5] * 44
