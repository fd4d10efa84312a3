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
    """Every module of the port imports, and neither jax nor any module of
    the JAX package comes with them."""
    code = (
        "import importlib, pkgutil, sys, lsc_planner_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "need = {'lsc_planner_tpu_torch.world.esdf', "
        "'lsc_planner_tpu_torch.world.corridor', "
        "'lsc_planner_tpu_torch.ops.grid_search', "
        "'lsc_planner_tpu_torch.ops.wavefront', "
        "'lsc_planner_tpu_torch.config', 'lsc_planner_tpu_torch.missions', "
        "'lsc_planner_tpu_torch.world.octomap_io', "
        "'lsc_planner_tpu_torch.world.mapping', "
        "'lsc_planner_tpu_torch.sim.obstacles', "
        "'lsc_planner_tpu_torch.sim.kalman', "
        "'lsc_planner_tpu_torch.ops.geometry', "
        "'lsc_planner_tpu_torch.ops.orca', "
        "'lsc_planner_tpu_torch.sim.logging', "
        "'lsc_planner_tpu_torch.sim.replay', "
        "'lsc_planner_tpu_torch.sim.command', "
        "'lsc_planner_tpu_torch.sim.debug', "
        "'lsc_planner_tpu_torch.sim.msgs', "
        "'lsc_planner_tpu_torch.sim.lpfile', "
        "'lsc_planner_tpu_torch.sim.visualize', "
        "'lsc_planner_tpu_torch.parallel.shard', "
        "'lsc_planner_tpu_torch.parallel.launch', "
        "'lsc_planner_tpu_torch.parallel.ranks', "
        "'lsc_planner_tpu_torch.cli'}\n"
        "assert need <= set(names), need - set(names)\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'lsc_planner_tpu' or "
        "m.startswith('lsc_planner_tpu.') or m == 'matplotlib']\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n")
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


def test_cholesky_batched_plain_matches_pallas_interpret(rng):
    """The factor alone in f32 (the TPU kernel is f32): the plain version
    within relative 1e-4 of the interpret-mode kernel, zeros above the
    diagonal, and a non-SPD entry non-finite in both, alone."""
    H, _, _ = _ipm_like(rng, 6, 13, np.float32)
    H[2, 4, 4] = -3.0
    Lj = np.asarray(chol_pallas.cholesky_batched(jnp.asarray(H),
                                                 interpret=True, block_b=8))
    Lt = chol.cholesky_batched(_t(H)).numpy()
    bad_j = ~np.isfinite(Lj).all((-2, -1))
    bad_t = ~np.isfinite(Lt).all((-2, -1))
    np.testing.assert_array_equal(bad_t, bad_j)
    assert bad_t.nonzero()[0].tolist() == [2]
    ok = ~bad_t
    assert _rel_err(Lt[ok], Lj[ok]) <= 1e-4
    assert (np.triu(Lt, 1) == 0).all() and (np.triu(Lj, 1) == 0).all()
    assert np.isnan(np.tril(Lt[2])[np.tril_indices(13)]).all()


@pytest.mark.parametrize("dtype,bits", [(np.float64, np.uint64),
                                        (np.float32, np.uint32)])
def test_cholesky_batched_plain_is_factor_solve_plain_factor(rng, dtype,
                                                             bits):
    """The factor alone is factor_solve's factor, bit for bit, SPD and
    non-SPD entries alike (the invariant the CUDA kernels hold by sharing
    one kernel): a failed entry's lower triangle NaN, zeros above the
    diagonal in every entry."""
    H, r1, _ = _ipm_like(rng, 6, 13, dtype)
    H[2, 4, 4] = -3.0
    H[4] = -np.eye(13, dtype=dtype)
    L = chol.cholesky_batched_plain(_t(H)).numpy()
    Lf = chol.chol_factor_solve_plain(_t(H), _t(r1))[0].numpy()
    np.testing.assert_array_equal(L.view(bits), Lf.view(bits))
    bad = ~np.isfinite(L).all((-2, -1))
    assert bad.nonzero()[0].tolist() == [2, 4]
    low = np.tril(np.ones((13, 13), bool))
    assert np.isnan(L[bad][:, low]).all()
    assert (np.triu(L, 1) == 0).all()


def test_chol_check_of_the_factor_alone():
    """The factor alone passes no right-hand side to the wrappers' check:
    a contiguous (B, n, n) batch goes to the kernel as it is, a batch of
    more dimensions is flattened and restored, and what the kernel does
    not take raises before any launch."""
    H = torch.zeros(6, 4, 4)
    H3, r, batch, n = chol._check(H, None, "cholesky_batched")
    assert H3 is H and r is None and batch is None and n == 4
    H3, r, batch, n = chol._check(torch.zeros(3, 2, 5, 5), None, "f")
    assert H3.shape == (6, 5, 5) and r is None and batch == (3, 2)
    big = chol.MAX_N + 1       # past the cap (a view, no memory)
    for bad, err in ((torch.zeros(2, 3, 4), ValueError),
                     (torch.zeros(1, 1, 1).expand(2, big, big), ValueError),
                     (torch.zeros(2, 3, 3, dtype=torch.int32), TypeError)):
        with pytest.raises(err, match="cholesky_batched"):
            chol._check(bad, None, "cholesky_batched")


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
    with pytest.raises(RuntimeError, match="CUDA"):
        chol._factor_cuda(_t(H))
    meta = torch.empty((2, 5, 5), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        chol.chol_factor_solve(meta, torch.empty((2, 5), device="meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        chol.chol_resolve(meta, torch.empty((2, 5), device="meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        chol.cholesky_batched(meta)
    assert chol.factor_solve_launches == 0 and chol.resolve_launches == 0
    assert chol.factor_launches == 0


def test_build_lock_is_taken_in_turn():
    """Two processes asking for the same library take its build lock one
    after the other (each holds it 0.5 s): ranks that start together build
    each library once.  The lock is the build's own (no nvcc needed)."""
    code = (
        "import sys, time\n"
        "from lsc_planner_tpu_torch.ops import _build\n"
        "with _build.build_lock(_build.library_path()):\n"
        "    t0 = time.time(); time.sleep(0.5); t1 = time.time()\n"
        "print(t0, t1)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    spans = []
    for proc in procs:
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0
        spans.append(tuple(float(x) for x in out.split()))
    (a0, a1), (b0, b1) = sorted(spans)
    assert a1 - a0 >= 0.5 and b1 - b0 >= 0.5
    assert b0 >= a1, f"the holds overlap: {spans}"


def test_chol_plain_versions_do_not_count(rng):
    chol.reset_counts()
    H, r1, r2 = _ipm_like(rng, 3, 7, np.float64)
    L, _ = chol.chol_factor_solve(_t(H), _t(r1))
    chol.chol_resolve(L, _t(r2))
    chol.cholesky_batched(_t(H))
    assert (chol.factor_solve_launches, chol.resolve_launches,
            chol.factor_launches) == (0, 0, 0)


# the largest n a cluster of one or two blocks holds (chol.large_plan)
CLUSTER_LAST_N = {torch.float32: 384, torch.float64: 256}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_large_plan_every_n(dtype):
    """Every 64 < n <= MAX_N has a large-n design, by shape alone: a
    cluster plan up to the largest n a cluster of CLUSTER_SIZES' largest
    holds, the tiled design past it.  A plan's bytes are its largest
    block's, fit a block's SMEM_CAP, and no smaller cluster fits; n <= 64
    has no large-n design."""
    elem = torch.empty((), dtype=dtype).element_size()
    last = CLUSTER_LAST_N[dtype]
    for n in range(chol.WARP_MAX_N + 1, chol.MAX_N + 1):
        plan = chol.large_plan(n, dtype)
        if n > last:
            assert plan is None and chol.large_design(n, dtype) == "tiled"
            continue
        G, smem = plan
        assert chol.large_design(n, dtype) == "cluster"
        assert smem == max(chol.cluster_smem_bytes(n, G, elem, r)
                           for r in range(G)) <= chol.SMEM_CAP
        for smaller in chol.CLUSTER_SIZES:
            if smaller < G:
                assert max(chol.cluster_smem_bytes(n, smaller, elem, r)
                           for r in range(smaller)) > chol.SMEM_CAP, n
    assert chol.large_plan(chol.WARP_MAX_N, dtype) is None
    assert chol.large_design(chol.WARP_MAX_N, dtype) is None
    assert chol.large_plan(chol.MAX_N + 1, dtype) is None


@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [65, 96, 199, 359, 365, 399, 640, 1024])
def test_cluster_covers_the_lower_triangle(n, G):
    """Over a cluster of G blocks the tiles are exactly the lower
    triangle's (a, c), c <= a, each in one block, block r holding the
    contiguous tile rows of cluster_cuts; a block numbers its tiles 0..
    without gaps, and its slots follow them, one for each earlier block's
    tile row c >= 1 (the rows whose panel tiles it reads)."""
    nt = -(-n // chol.TILE)
    cuts = chol.cluster_cuts(n, G)
    assert cuts[0] == 0 and cuts[-1] == nt and cuts == sorted(cuts)
    seen = {}
    for rank in range(G):
        own, slots = chol.cluster_tiles(n, G, rank)
        for a, c in own:
            assert cuts[rank] <= a < cuts[rank + 1] and (a, c) not in seen
            seen[(a, c)] = rank
        assert sorted(own.values()) == list(range(len(own)))
        assert sorted(slots) == list(range(1, cuts[rank]))
        assert sorted(slots.values()) == list(range(len(own),
                                                    len(own) + len(slots)))
    assert set(seen) == {(a, c) for a in range(nt) for c in range(a + 1)}


def test_large_n_plain_versions_do_not_count():
    """At a large n the wrappers run the plain versions on a CPU tensor,
    and no large-n counter moves."""
    chol.reset_counts()
    H = torch.eye(100, dtype=torch.float64)[None]
    L, _ = chol.chol_factor_solve(H, torch.ones(1, 100, dtype=torch.float64))
    chol.chol_resolve(L, torch.ones(1, 100, dtype=torch.float64))
    assert (chol.factor_solve_cluster_launches, chol.resolve_cluster_launches,
            chol.factor_cluster_launches, chol.factor_solve_tiled_launches,
            chol.resolve_tiled_launches, chol.factor_tiled_launches) == \
        (0,) * 6


# the tiled design's shapes: past the clusters, the slack QP's n at 96
# agents (525), and past the first design's cap of 1024
TILED_NS = (385, 399, 525, 641, 1024, 1100, 1536)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", TILED_NS)
def test_tiled_schedule(n, dtype):
    """The tiled factor's task order (chol.tiled_tasks, tiled_task: the
    kernel's task_of) at n: every lower tile is produced by exactly one
    task; every tile a task reads ((i, k) and (j, k) of its k-sum, and
    L_jj for i > j) is produced earlier, for its own batch entry, in the
    order over a batch; each k-sum runs in increasing k; each entry's last
    task comes after all of its tiles; and the workspace has a flag for
    each task."""
    assert chol.large_design(n, dtype) == "tiled"
    nt = -(-n // chol.TILED_TILE)
    tasks = chol.tiled_tasks(n)
    where = {}
    for p, (i, j, ks) in enumerate(tasks):
        assert 0 <= j <= i < nt and (i, j) not in where
        assert ks == sorted(ks) == list(range(j))
        reads = [(i, k) for k in ks] + [(j, k) for k in ks] + \
            ([(j, j)] if i > j else [])
        assert all(where.get(tile, p) < p for tile in reads), (i, j)
        assert all(tile in where for tile in reads), (i, j)
        where[(i, j)] = p
    assert set(where) == {(i, j) for i in range(nt) for j in range(i + 1)}
    B = 3
    order = [chol.tiled_task(t, n, B) for t in range(B * (len(tasks) + 1))]
    seen = set()
    for b, i, j in order:
        if i < 0:
            assert all((b, a, c) in seen for a, c in where)
            continue
        reads = [(i, k) for k in range(j)] + [(j, k) for k in range(j)] + \
            ([(j, j)] if i > j else [])
        assert all((b, a, c) in seen for a, c in reads)
        seen.add((b, i, j))
    assert len(seen) == B * len(tasks)
    assert chol.tiled_work_ints(n, B) == 1 + B + B * len(tasks)


def _tiled_factor_emulated(H, tile):
    """The tiled factor's arithmetic in plain torch (csrc/chol_tiled.cuh):
    each lower tile (i, j) in the kernel's task order takes H_ij and, for
    k = 0 .. j - 1 in increasing order, subtracts L_ik L_jk^T summed in
    partial sums of its own one column of the k-tile at a time, then runs
    the block's POTRF (potrf_blocked: in 16-column steps, the
    diagonal block's column c its pivot's square root d and the entries
    below times 1 / d, the later columns updated by it, the rows below it
    solved against it, the
    trailing triangle updated) or TRSM (column c times 1 / L_jj[c][c],
    the later columns updated by L_jj's column c); the last tile row and
    column padded with the identity."""
    B, n = H.shape[0], H.shape[-1]
    nt = -(-n // tile)
    m = nt * tile
    A = torch.eye(m, dtype=H.dtype).repeat(B, 1, 1)
    A[:, :n, :n] = H
    L = torch.zeros_like(A)

    def blk(X, a, c):
        return X[:, a * tile:(a + 1) * tile, c * tile:(c + 1) * tile]
    for i, j, ks in chol.tiled_tasks(n, tile):
        acc = blk(A, i, j).clone()
        for k in ks:
            Li, Lj = blk(L, i, k), blk(L, j, k)
            part = torch.zeros_like(acc)
            for kk in range(tile):
                part += Li[:, :, kk, None] * Lj[:, None, :, kk]
            acc -= part
        if i == j:
            pb = 16
            for k0 in range(0, tile, pb):
                k1 = k0 + pb
                for c in range(k0, k1):       # the diagonal block
                    d = torch.sqrt(acc[:, c, c])
                    col = acc[:, c:k1, c] * (1.0 / d)[:, None]
                    col[:, 0] = d
                    acc[:, c:k1, c + 1:k1] -= \
                        col[:, :, None] * col[:, None, 1:]
                    acc[:, c:k1, c] = col
                for c in range(k0, k1):       # the rows below it
                    col = acc[:, k1:, c] * (1.0 / acc[:, c, c])[:, None]
                    acc[:, k1:, c + 1:k1] -= \
                        col[:, :, None] * acc[:, None, c + 1:k1, c]
                    acc[:, k1:, c] = col
                for k in range(k0, k1):       # the trailing triangle
                    acc[:, k1:, k1:] -= \
                        acc[:, k1:, k, None] * acc[:, None, k1:, k]
            acc = torch.tril(acc)
        else:
            D = blk(L, j, j)
            for c in range(tile):
                col = acc[:, :, c] * (1.0 / D[:, c, c])[:, None]
                acc[:, :, c + 1:] -= col[:, :, None] * D[:, None, c + 1:, c]
                acc[:, :, c] = col
        blk(L, i, j)[:] = acc
    return L[:, :n, :n]


@pytest.mark.parametrize("n", [100, 200])
def test_tiled_emulation_matches_jax(rng, n):
    """The tiled factor's tiles and accumulation order, emulated in f64
    with a 32 tile, against the JAX package's factor off the TPU
    (lsc_planner_tpu/ops/qp.py::_cholesky, jnp.linalg.cholesky) on the
    same SPD inputs: max abs difference <= 1e-12 (unit-diagonal inputs,
    factors O(1); f64 rounding in two summation orders)."""
    from lsc_planner_tpu.ops import qp as jqp

    H, _, _ = _ipm_like(rng, 3, n, np.float64)
    want = np.asarray(jqp._cholesky(jnp.asarray(H)))
    got = _tiled_factor_emulated(torch.as_tensor(H), 32).numpy()
    assert np.abs(got - want).max() <= 1e-12


def test_wavefront_cuda_branch_raises_without_gpu():
    """The wavefront wrapper never runs the plain version on a CUDA
    tensor: without a GPU the loader raises; a grid too large for one
    block's shared memory raises before any launch; the plain version
    never counts."""
    from lsc_planner_tpu_torch.ops import wavefront

    wavefront.reset_counts()
    occ = torch.zeros((2, 3, 4, 5))
    goal = torch.zeros((2, 3), dtype=torch.int32)
    wavefront.wavefront_batched(occ, goal, 16)
    assert wavefront.wavefront_launches == 0
    with pytest.raises(ValueError, match="shared memory"):
        wavefront._check(torch.zeros((1, 1, 3227, 64)), goal[:1])
    wavefront._check(torch.zeros((1, 11, 61, 61)), goal[:1])
    wavefront._check(torch.zeros((20, 11, 41, 41)),
                     torch.zeros((20, 3), dtype=torch.int32))
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU branch cannot run")
    with pytest.raises(RuntimeError, match="CUDA"):
        wavefront._wavefront_cuda(occ, goal, 16)
    with pytest.raises(RuntimeError, match="no kernel"):
        wavefront.wavefront_batched(occ.to("meta"), goal.to("meta"), 16)
