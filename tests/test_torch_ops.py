"""Port parity: ops (bernstein, hull, chol) against the JAX package.

The same numpy inputs go through the JAX function (CPU, float64 under
conftest) and its PyTorch counterpart.  Stated tolerances: bernstein and
hull max abs diff <= 1e-9 (f64); chol plain versions vs the interpret-mode
Pallas kernels relative <= 1e-10 in f64 and <= 1e-4 in f32.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_planner_tpu.ops import bernstein as jbz
from lsc_planner_tpu.ops import chol_pallas
from lsc_planner_tpu.ops import hull as jhull
from lsc_planner_tpu_torch.ops import _build
from lsc_planner_tpu_torch.ops import bernstein as tbz
from lsc_planner_tpu_torch.ops import chol
from lsc_planner_tpu_torch.ops import hull as thull

TOL = 1e-9


def _t(a):
    return torch.as_tensor(np.array(a))


def test_import_leaves_jax_out():
    code = ("import sys, lsc_planner_tpu_torch, "
            "lsc_planner_tpu_torch.convert, "
            "lsc_planner_tpu_torch.sim.simulator; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "import torch; "
            "assert not torch.backends.cuda.matmul.allow_tf32; "
            "assert not torch.backends.cudnn.allow_tf32")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


# ---------------------------------------------------------------- bernstein
@pytest.mark.parametrize("name,args", [
    ("bernstein_matrix", (5,)), ("bernstein_matrix", (7,)),
    ("q_base", (5, 3, 1, 0.2)), ("q_base", (7, 4, 2, 0.3)),
    ("subdivision_matrix", (5, 0.25, 0.75)),
])
def test_bernstein_tables_equal(name, args):
    np.testing.assert_array_equal(getattr(tbz, name)(*args),
                                  getattr(jbz, name)(*args))


@pytest.mark.parametrize("t", [0.0, 0.13, 0.5, 1.0])
def test_bernstein_eval_and_derivative(rng, t):
    ctrl = rng.normal(size=(4, 3, 6, 3))
    got = tbz.bernstein_eval(_t(ctrl), t).numpy()
    want = np.asarray(jbz.bernstein_eval(jnp.asarray(ctrl), t))
    assert np.abs(got - want).max() <= TOL
    got = tbz.derivative_ctrl(_t(ctrl), 0.2).numpy()
    want = np.asarray(jbz.derivative_ctrl(jnp.asarray(ctrl), 0.2))
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("t", [0.0, 0.2, 0.37, 0.99])
def test_traj_state_batch(rng, t):
    trajs = rng.normal(size=(5, 5, 6, 3))
    got = tbz.traj_state_batch(_t(trajs), t, 0.2)
    want = jbz.traj_state_batch(jnp.asarray(trajs), t, 0.2)
    for key in ("pos", "vel", "acc", "jerk", "omega"):
        assert np.abs(got[key].numpy() - np.asarray(want[key])).max() <= \
            TOL * max(1.0, np.abs(np.asarray(want[key])).max()), key


# ---------------------------------------------------------------- hull
def _hull_points(rng, n=64):
    """Relative control-point sets like lsc_planes feeds: separated
    trajectories, crossing ones (origin inside), and near-parallel far
    ones (the f32-sensitive case)."""
    base = rng.normal(size=(n, 6, 3))
    far = base * 0.05 + rng.normal(size=(n, 1, 3)) * 10.0
    crossing = base - base.mean(axis=1, keepdims=True)
    return np.concatenate([base + 2.0, far, crossing], axis=0)


def test_hull_normal_matches(rng):
    pts = _hull_points(rng)
    n_t, d_t = thull.hull_normal(_t(pts))
    n_j, d_j = jhull.hull_normal(jnp.asarray(pts))
    assert np.abs(n_t.numpy() - np.asarray(n_j)).max() <= TOL
    assert np.abs(d_t.numpy() - np.asarray(d_j)).max() <= TOL


@pytest.mark.parametrize("K", [3, 4, 6])
def test_closest_point_to_hull_matches(rng, K):
    pts = _hull_points(rng, 32)[:, :K]
    c_t, d_t = thull.closest_point_to_hull(_t(pts))
    c_j, d_j = jhull.closest_point_to_hull(jnp.asarray(pts))
    assert np.abs(c_t.numpy() - np.asarray(c_j)).max() <= TOL
    assert np.abs(d_t.numpy() - np.asarray(d_j)).max() <= TOL


def test_hull_fista_branch_not_ported(rng):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        thull.closest_point_to_hull(_t(rng.normal(size=(2, 9, 3))))


# ---------------------------------------------------------------- chol
def _ipm_like(rng, B, n, dtype):
    A = rng.normal(size=(B, 2 * n, n))
    d = np.exp(rng.uniform(-4.0, 4.0, size=(B, 2 * n)))
    H = np.eye(n) + np.einsum("brv,br,brw->bvw", A, d, A)
    dsc = 1.0 / np.sqrt(np.einsum("bvv->bv", H))
    Hs = H * dsc[:, :, None] * dsc[:, None, :]
    return (Hs.astype(dtype), rng.normal(size=(B, n)).astype(dtype),
            rng.normal(size=(B, n)).astype(dtype))


def _rel_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype,tol,B,n", [
    (np.float64, 1e-10, 5, 13), (np.float32, 1e-4, 5, 13),
    (np.float32, 1e-4, 11, 39),         # the QP's n (interpret is slow)
])
def test_chol_plain_matches_pallas_interpret(rng, dtype, tol, B, n):
    H, r1, r2 = _ipm_like(rng, B, n, dtype)
    Lj, xj = chol_pallas.chol_factor_solve(jnp.asarray(H), jnp.asarray(r1),
                                           interpret=True, block_b=8)
    yj = chol_pallas.chol_resolve(Lj, jnp.asarray(r2), interpret=True,
                                  block_b=8)
    Lt, xt = chol.chol_factor_solve(_t(H), _t(r1))
    yt = chol.chol_resolve(Lt, _t(r2))
    assert xt.dtype == torch.from_numpy(H).dtype
    assert _rel_err(xt.numpy(), np.asarray(xj)) <= tol
    assert _rel_err(yt.numpy(), np.asarray(yj)) <= tol
    # the Pallas factor is (n, n, Bp) lanes; the port's is (B, n, n)
    L_lanes = np.transpose(np.asarray(Lj)[:, :, :B], (2, 0, 1))
    assert _rel_err(Lt.numpy(), L_lanes) <= tol


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_chol_nan_in_same_entries(rng, dtype):
    H, r1, _ = _ipm_like(rng, 6, 13, dtype)
    H[2, 4, 4] = -3.0
    H[4] = -np.eye(13, dtype=dtype)
    _, xj = chol_pallas.chol_factor_solve(jnp.asarray(H), jnp.asarray(r1),
                                          interpret=True, block_b=8)
    _, xt = chol.chol_factor_solve(_t(H), _t(r1))
    bad_j = ~np.isfinite(np.asarray(xj)).all(-1)
    bad_t = ~torch.isfinite(xt).all(-1).numpy()
    np.testing.assert_array_equal(bad_t, bad_j)
    assert bad_t.nonzero()[0].tolist() == [2, 4]


def test_chol_cuda_branch_raises_without_gpu(rng):
    """A CUDA tensor never reaches the plain versions: without a GPU the
    kernel loader raises, and other devices are refused."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU branch cannot run")
    H, r1, _ = _ipm_like(rng, 2, 5, np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.load_library()
    with pytest.raises(RuntimeError, match="CUDA"):
        chol._factor_solve_cuda(_t(H), _t(r1))
    with pytest.raises(RuntimeError, match="CUDA"):
        chol._resolve_cuda(_t(H), _t(r1))
    meta = torch.empty((2, 5, 5), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        chol.chol_factor_solve(meta, torch.empty((2, 5), device="meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        chol.chol_resolve(meta, torch.empty((2, 5), device="meta"))
    assert chol.factor_solve_launches == 0 and chol.resolve_launches == 0


def test_chol_plain_versions_do_not_count(rng):
    chol.reset_counts()
    H, r1, r2 = _ipm_like(rng, 3, 7, np.float64)
    L, _ = chol.chol_factor_solve(_t(H), _t(r1))
    chol.chol_resolve(L, _t(r2))
    assert (chol.factor_solve_launches, chol.resolve_launches) == (0, 0)
