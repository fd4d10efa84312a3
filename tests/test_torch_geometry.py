"""Port parity: the rest of the JAX package's library surface -- the
collision-geometry helpers of ops/geometry.py, bernstein_fitting and
subdivide, the FISTA branch of the hull's closest point, box_pair_planes,
the mission services update_goals and go_back, and sim/visualize.py with
the CLI's --plot.

Stated tolerances (f64): the geometry helpers within 1e-10 of JAX on
seeded random inputs, and JAX's own golden values from tests/test_aux.py;
bernstein_fitting and subdivide within 1e-10; the FISTA closest point
within 1e-9 at the same iteration count; box_pair_planes within 1e-9.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_planner_tpu.config import GoalMode
from lsc_planner_tpu.ops import bernstein as jbz
from lsc_planner_tpu.ops import geometry as jgeo
from lsc_planner_tpu.ops import hull as jhull
from lsc_planner_tpu.planner.constraints import box_pair_planes as j_bpp
from lsc_planner_tpu.sim.simulator import SyncSimulator as JSim
from lsc_planner_tpu_torch import cli
from lsc_planner_tpu_torch.ops import bernstein as tbz
from lsc_planner_tpu_torch.ops import geometry as tgeo
from lsc_planner_tpu_torch.ops import hull as thull
from lsc_planner_tpu_torch.planner.constraints import box_pair_planes
from lsc_planner_tpu_torch.sim.logging import ResultLogger
from lsc_planner_tpu_torch.sim.replay import read_result_csv
from lsc_planner_tpu_torch.sim.simulator import SyncSimulator as TSim
from lsc_planner_tpu_torch.sim.visualize import (plot_run,
                                                 save_normal_vector_csv)
from torch_parity import (missions, params, port_state,  # noqa: F401
                          torch_one_thread)

TOL = 1e-10


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
        return
    # equal infinities count as equal
    same_inf = np.isinf(want) & (got == want)
    with np.errstate(invalid="ignore"):
        assert np.all(same_inf | (np.abs(got - want) <= tol))


# ------------------------------------------------------------ geometry
def _segments(rng, n=64):
    """Segments and boxes that hit, graze and miss: starts around the
    boxes, some motionless, some on a box face's line."""
    start = rng.normal(size=(n, 3)) * 2.0
    goal = start + rng.normal(size=(n, 3)) * 3.0
    goal[::7] = start[::7]                      # not moving
    goal[3::11, 1] = start[3::11, 1]            # moving in a plane
    centre = rng.normal(size=(n, 3))
    half = rng.uniform(0.2, 1.5, size=(n, 3))
    return start, goal, centre - half, centre + half


def test_distance_helpers_match(rng):
    """ellipsoidal_distance, downwash_transform, pair_downwash,
    point_box_distance and closest_between_segments on random inputs."""
    p1, p2 = rng.normal(size=(2, 40, 3))
    dw = rng.uniform(1.0, 3.0, size=40)
    r1, r2 = rng.uniform(0.1, 0.4, size=(2, 40))
    _close(tgeo.ellipsoidal_distance(_t(p1), _t(p2), _t(dw)),
           jgeo.ellipsoidal_distance(jnp.asarray(p1), jnp.asarray(p2),
                                     jnp.asarray(dw)))
    _close(tgeo.downwash_transform(_t(p1), _t(dw)),
           jgeo.downwash_transform(jnp.asarray(p1), jnp.asarray(dw)))
    _close(tgeo.pair_downwash(_t(r1), _t(dw), _t(r2), _t(dw[::-1])),
           jgeo.pair_downwash(jnp.asarray(r1), jnp.asarray(dw),
                              jnp.asarray(r2), jnp.asarray(dw[::-1])))
    start, goal, lo, hi = _segments(rng)
    _close(tgeo.point_box_distance(_t(start), _t(lo), _t(hi)),
           jgeo.point_box_distance(jnp.asarray(start), jnp.asarray(lo),
                                   jnp.asarray(hi)))
    a0, a1, b0, b1 = rng.normal(size=(4, 40, 3))
    a1[::5] = a0[::5]                           # a point, not a segment
    b1[1::6] = b0[1::6] + (a1 - a0)[1::6]       # parallel segments
    got = tgeo.closest_between_segments(_t(a0), _t(a1), _t(b0), _t(b1))
    want = jgeo.closest_between_segments(*map(jnp.asarray, (a0, a1, b0,
                                                            b1)))
    for g, w in zip(got, want):
        _close(g, w)


def test_segment_box_helpers_match(rng):
    """segment_box_distance (48 ternary steps), segment_box_collision,
    box_collision_time and safe_dist_in_direction with and without boxes,
    on random inputs."""
    start, goal, lo, hi = _segments(rng)
    radius = rng.uniform(0.1, 0.6, size=start.shape[0])
    J = [jnp.asarray(a) for a in (start, goal, lo, hi, radius)]
    T = [_t(a) for a in (start, goal, lo, hi, radius)]
    _close(tgeo.segment_box_distance(*T[:4]),
           jgeo.segment_box_distance(*J[:4]))
    hits = tgeo.segment_box_collision(*T)
    _close(hits, jgeo.segment_box_collision(*J))
    assert 0 < int(hits.sum()) < len(hits)
    t_hit = tgeo.box_collision_time(*T, 2.0)
    _close(t_hit, jgeo.box_collision_time(*J, 2.0))
    assert np.isinf(t_hit.numpy()).any() and np.isfinite(t_hit.numpy()).any()

    pos = rng.normal(size=(16, 3))
    d = rng.normal(size=(16, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    obs = pos[:, None, :] + rng.normal(size=(16, 5, 3)) * 2.0
    orad = rng.uniform(0.1, 0.4, size=(16, 5))
    rad = rng.uniform(0.1, 0.3, size=16)
    boxes = np.concatenate([lo[:6], hi[:6]], axis=-1)
    for bx in (None, boxes):
        got = tgeo.safe_dist_in_direction(
            _t(pos), _t(d), _t(obs), _t(orad), _t(rad),
            boxes=None if bx is None else _t(bx))
        want = jgeo.safe_dist_in_direction(
            jnp.asarray(pos), jnp.asarray(d), jnp.asarray(obs),
            jnp.asarray(orad), jnp.asarray(rad),
            boxes=None if bx is None else jnp.asarray(bx))
        _close(got, want)
    # no obstacles: the ray is clear
    clear = tgeo.safe_dist_in_direction(_t(pos), _t(d), _t(obs[:, :0]),
                                        _t(orad[:, :0]), _t(rad))
    assert torch.isinf(clear).all()


def test_geometry_golden_cases():
    """tests/test_aux.py:219-300's golden values of the JAX package."""
    bmin, bmax = _t([[-1.0, -1.0, -1.0]]), _t([[1.0, 1.0, 1.0]])
    r = _t([0.25])
    collide = [([-3.0, 0, 0], [3.0, 0, 0], True),       # straight through
               ([-3.0, 1.23, 1.23], [3.0, 1.23, 1.23], False),  # corner
               ([-3.0, 1.2, 0.0], [3.0, 1.2, 0.0], True),        # face
               ([4.0, 0, 0], [4.0, 0, 0], False)]                # static
    for s, g, want in collide:
        assert bool(tgeo.segment_box_collision(_t([s]), _t([g]), bmin, bmax,
                                               r)[0]) is want
    bmin, bmax, r = _t([1.0, -1.0, -1.0]), _t([2.0, 1.0, 1.0]), _t(0.5)
    t = tgeo.box_collision_time(_t([-1.0, 0, 0]), _t([3.0, 0, 0]), bmin,
                                bmax, r, 1.0)
    assert abs(float(t) - 1.5 / 4.0) <= 1e-6
    t = tgeo.box_collision_time(_t([-1.0, 3.0, 0]), _t([3.0, 3.0, 0]), bmin,
                                bmax, r, 1.0)
    assert np.isinf(float(t))
    pos, dirn = _t([0.0, 0.0, 0.0]), _t([1.0, 0.0, 0.0])
    obs, orad, r = _t([[3.0, 0.3, 0.0], [10.0, 5.0, 0.0]]), _t([0.2, 0.2]), \
        _t(0.2)
    d = tgeo.safe_dist_in_direction(pos, dirn, obs, orad, r)
    assert abs(float(d) - (3.0 - np.sqrt(0.07))) <= 1e-6
    boxes = _t([[2.0, -1.0, -1.0, 4.0, 1.0, 1.0]])
    d = tgeo.safe_dist_in_direction(pos, dirn, obs, orad, r, boxes=boxes)
    assert abs(float(d) - 1.8) <= 1e-5
    # closest points between segments against a dense sampling oracle
    rng = np.random.default_rng(42)
    a0, a1, b0, b1 = rng.normal(size=(4, 40, 3))
    pa, pb, dist = tgeo.closest_between_segments(_t(a0), _t(a1), _t(b0),
                                                 _t(b1))
    ts = np.linspace(0, 1, 401)
    for k in range(40):
        P = a0[k][None] + ts[:, None] * (a1[k] - a0[k])[None]
        Q = b0[k][None] + ts[:, None] * (b1[k] - b0[k])[None]
        oracle = np.min(np.linalg.norm(P[:, None] - Q[None], axis=-1))
        assert float(dist[k]) <= oracle + 1e-9
        assert abs(float(torch.linalg.vector_norm(pa[k] - pb[k])) -
                   float(dist[k])) <= 1e-9


# ------------------------------------------------------------ bernstein
def test_bernstein_fitting_and_subdivide_match(rng):
    """tests/test_bernstein.py:112-130: fitting through a curve's samples
    returns its control points; subdivide(c, a, b) is p(b + a t)."""
    ctrl = rng.normal(size=(6, 3))
    ts = np.linspace(0, 1, 6)
    targets = np.stack([np.asarray(jbz.bernstein_eval(jnp.asarray(ctrl), t))
                        for t in ts])
    fitted = tbz.bernstein_fitting(_t(targets), _t(ts))
    _close(fitted, jbz.bernstein_fitting(jnp.asarray(targets),
                                         jnp.asarray(ts)))
    assert np.abs(fitted.numpy() - ctrl).max() <= 1e-8
    batch = rng.normal(size=(4, 2, 6, 3))
    for a, b in ((0.5, 0.3), (0.25, 0.0), (1.0, 0.0)):
        sub = tbz.subdivide(_t(batch), a, b)
        _close(sub, jbz.subdivide(jnp.asarray(batch), a, b))
        for t in (0.0, 0.4, 1.0):
            _close(tbz.bernstein_eval(sub, t),
                   tbz.bernstein_eval(_t(batch), b + a * t), 1e-9)


# ------------------------------------------------------------ hull (FISTA)
def test_project_simplex_matches(rng):
    v = rng.normal(size=(32, 12)) * 2.0
    v[::4, 3] = v[::4, 5]                       # ties
    got = thull.project_simplex(_t(v))
    _close(got, jhull.project_simplex(jnp.asarray(v)), 1e-12)
    assert np.abs(got.numpy().sum(-1) - 1.0).max() <= 1e-12
    assert (got.numpy() >= 0).all()


@pytest.mark.parametrize("K", [9, 12, 16])
def test_closest_point_fista_matches(rng, K):
    """K > 8 points take the FISTA branch: JAX's 256 steps (and 300 when
    asked), separated sets and sets around the origin."""
    base = rng.normal(size=(24, K, 3))
    pts = np.concatenate([base + 2.0, base - base.mean(1, keepdims=True)])
    for iters in (0, 300):
        c_t, d_t = thull.closest_point_to_hull(_t(pts), iters=iters)
        c_j, d_j = jhull.closest_point_to_hull(jnp.asarray(pts),
                                               iters=iters)
        _close(c_t, c_j, 1e-9)
        _close(d_t, d_j, 1e-9)


def test_box_pair_planes_match():
    """tests/test_world.py:154-180's L-shaped pair (an incut edge, 9
    projected points: the FISTA branch) and a disjoint pair, against JAX;
    the plane keeps the hull and cuts the incut corner off."""
    hull = np.array([[0.5, 0.5, 0.5], [1.5, 0.5, 0.5], [1.5, 1.5, 0.5]])
    args = (hull, [0, 0, 0], [2, 1, 1], [1, 0, 0], [3, 2, 1])
    pts, nrms = box_pair_planes(*args)
    want_pts, want_nrms = j_bpp(*args)
    assert len(pts) >= 1
    _close(pts, want_pts, 1e-9)
    _close(nrms, want_nrms, 1e-9)
    for p, n in zip(pts, nrms):
        assert ((hull - p) @ n).min() > -1e-6
    bad = np.array([0.2, 1.8, 0.5])
    assert any((bad - p) @ n < -1e-6 for p, n in zip(pts, nrms))
    pts, nrms = box_pair_planes(np.array([[0.5, 0.5, 0.5]]), [0, 0, 0],
                                [1, 1, 1], [2, 2, 2], [3, 3, 3])
    assert pts.shape == (0, 3) and nrms.shape == (0, 3)


# ------------------------------------------------------------ services
def test_update_goals_and_go_back():
    """tests/test_misc_modes.py:55 (update_goals: agents told to stop where
    they are stay within 0.2 m) held to JAX's cycles, and go_back swaps
    start and desired goal."""
    jm, tm = missions("make_circle_mission", 3, radius=2.0,
                      world=(-4, -4, 0, 4, 4, 2.5))
    jp, tp = params(goal_mode=GoalMode.STATIC, qp_iterations=10)
    jsim = JSim(jm, jp, dtype=jnp.float64)
    tsim = TSim(tm, tp, device="cpu", dtype=torch.float64)
    js, ts = jsim.initial_state(), tsim.initial_state()
    for _ in range(5):
        js, _ = jsim._cycle_jit(js)
        ts, _ = tsim.cycle(ts)
    new_goals = np.asarray(js.pos).copy()
    js = jsim.update_goals(js, new_goals)
    ts = tsim.update_goals(ts, new_goals)
    assert ts.desired_goal.dtype == torch.float64
    _close(ts.desired_goal, js.desired_goal, 0.0)
    for _ in range(30):
        js, _ = jsim._cycle_jit(js)
        ts, _ = tsim.cycle(ts)
    assert np.abs(ts.pos.numpy() - np.asarray(js.pos)).max() <= 1e-8
    assert np.linalg.norm(ts.pos.numpy() - new_goals, axis=-1).max() < 0.2
    back = tsim.go_back(ts)
    wback = jsim.go_back(js)
    _close(back.desired_goal, wback.desired_goal, 1e-8)
    _close(back.start, wback.start, 1e-8)
    assert torch.equal(back.desired_goal, ts.start)
    assert torch.equal(back.start, ts.desired_goal)


# ------------------------------------------------------------ visualize
def test_plot_run_and_normal_csv(tmp_path):
    """tests/test_aux.py:146-168 on a port run: the plot's PNG and the
    normal-vector CSV's header and rows."""
    _, tm = missions("make_circle_mission", 3, radius=2.0,
                     world=(-4, -4, 0, 4, 4, 2.5))
    _, tp = params(qp_iterations=10)
    sim = TSim(tm, tp, device="cpu", dtype=torch.float64)
    log = ResultLogger(str(tmp_path), sim.param, tm.qn)
    sim.run(max_iterations=40, log=log)
    out = plot_run(read_result_csv(log.path), str(tmp_path / "run.png"),
                   world_min=tm.world_min, world_max=tm.world_max,
                   max_vel=1.0, max_acc=2.0)
    assert os.path.getsize(out) > 10000
    path = save_normal_vector_csv(str(tmp_path / "normals.csv"), [0, 1],
                                  [np.zeros((3, 3, 3)) for _ in range(2)], 3)
    lines = open(path).read().strip().splitlines()
    assert lines[0] == "t,(0-1),(0-2),(1-2)"
    assert len(lines) == 3


def test_cli_plot(tmp_path, capsys):
    """The port's CLI with --save-result --plot on the CPU writes the
    PNG beside the summary."""
    mission = str(tmp_path / "c3.json")
    assert cli.main(["--generate", "circle:3", "--out", mission]) == 0
    png = str(tmp_path / "run.png")
    assert cli.main(["--mission", mission, "--device", "cpu",
                     "--max-iterations", "5", "--save-result",
                     "--log-dir", str(tmp_path / "log"), "--plot", png,
                     "--set", "qp_iterations=8"]) == 0
    assert os.path.getsize(png) > 10000
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-2] == f"plot written to {png}"
    assert json.loads(out[-1])["iterations"] == 5
