"""Port parity: LSC planes, prediction, goal rule and the safety audit.

Stated tolerance: max abs diff <= 1e-9 (float64 on both sides).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_planner_tpu.config import GoalMode
from lsc_planner_tpu.planner import constraints as jcons
from lsc_planner_tpu.planner import goal as jgoal
from lsc_planner_tpu.planner import prediction as jpred
from lsc_planner_tpu.sim import audit as jaudit
from lsc_planner_tpu_torch.planner import constraints as tcons
from lsc_planner_tpu_torch.planner import goal as tgoal
from lsc_planner_tpu_torch.planner import prediction as tpred
from lsc_planner_tpu_torch.sim import audit as taudit
from torch_parity import missions, params

TOL = 1e-9


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= tol


def _swarm(rng, N=6, M=5, n1=6):
    """Trajectories of a small swarm around a circle, a few near-touching."""
    th = np.linspace(0, 2 * np.pi, N, endpoint=False)
    start = np.stack([2 * np.cos(th), 2 * np.sin(th), np.ones(N)], -1)
    drift = rng.normal(size=(N, 1, 1, 3)) * 0.4
    tau = np.linspace(0, 1, M * n1).reshape(1, M, n1, 1)
    traj = start[:, None, None] + drift * tau + \
        rng.normal(size=(N, M, n1, 3)) * 0.02
    return traj


@pytest.mark.parametrize("guard", [0.0, 0.004])
def test_lsc_planes_match(rng, guard):
    traj = _swarm(rng)
    N = traj.shape[0]
    radius = np.full(N, 0.15)
    downwash = rng.uniform(1.5, 2.5, size=N)
    obs_pred = np.broadcast_to(traj[None], (N,) + traj.shape)
    args = (traj, obs_pred, radius, downwash,
            np.broadcast_to(radius[None], (N, N)),
            np.broadcast_to(downwash[None], (N, N)),
            rng.uniform(size=(N, N)) > 0.3, ~np.eye(N, dtype=bool))
    j = jcons.lsc_planes(*map(jnp.asarray, args), guard_margin=guard)
    t = tcons.lsc_planes(*map(_t, args), guard_margin=guard)
    for a, b in zip(t, j):
        _close(a, b)
    jc = jcons.concat_planes(j, n_ctrl=6)
    tc = tcons.concat_planes(t, n_ctrl=6)
    for a, b in zip(tc, jc):
        _close(a, b)


def test_pair_downwash_matches(rng):
    args = [rng.uniform(0.1, 0.3, size=(4, 1)), rng.uniform(1, 3, (4, 1)),
            rng.uniform(0.1, 0.3, size=(4, 5)), rng.uniform(1, 3, (4, 5)),
            rng.uniform(size=(4, 5)) > 0.5]
    _close(tcons.pair_downwash(*map(_t, args)),
           jcons.pair_downwash(*map(jnp.asarray, args)))


def test_prediction_matches(rng):
    traj = rng.normal(size=(4, 5, 6, 3))
    _close(tpred.shift_previous_solution(_t(traj)),
           jpred.shift_previous_solution(jnp.asarray(traj)), 0.0)
    pos, vel = rng.normal(size=(4, 3)), rng.normal(size=(4, 3))
    _close(tpred.constant_velocity_traj(_t(pos), _t(vel), 5, 5, 0.2),
           jpred.constant_velocity_traj(jnp.asarray(pos), jnp.asarray(vel),
                                        5, 5, 0.2))


@pytest.mark.parametrize("mode", [GoalMode.PRIOR_BASED, GoalMode.STATIC])
def test_goal_planner_matches(rng, mode):
    N = 8
    jm, tm = missions("make_circle_mission", N, radius=1.0)
    jp, tp = params(goal_mode=mode)
    traj = _swarm(rng, N)
    traj[3] = traj[2] + np.array([0.2, 0.1, 0.0])   # inside the back-away
    pos = traj[:, 0, 0]                             # distance of agent 2
    goals = np.asarray([a.goal for a in jm.agents])
    goals[:2] = pos[:2] + 0.05            # two agents near their goals
    radius = np.full(N, 0.15)
    kw = dict(pos=pos, vel=rng.normal(size=(N, 3)), init_traj=traj,
              desired_goal=goals, seq=np.int32(3), radius=radius,
              downwash=np.full(N, 2.0))
    j = jgoal.GoalPlanner(jm, jp).plan(
        **{k: jnp.asarray(v) for k, v in kw.items()}, prev_traj=traj)
    t = tgoal.GoalPlanner(tm, tp).plan(
        **{k: _t(v) for k, v in kw.items()}, prev_traj=_t(traj))
    for a, b in zip(t, j):
        _close(a, b)


def test_goal_planner_off_slice_raises():
    """The ORCA goal mode raises ValueError with a planner mode that has
    no ORCA velocities, and when plan() is given none; with them, its
    goals equal the JAX package's.  With an ESDF the planner builds the
    grid planner on the JAX package's grid, with the exact castRay option
    too, at the JAX package's recursion depth."""
    from lsc_planner_tpu.config import PlannerMode
    from lsc_planner_tpu.world.esdf import ESDF as JESDF
    from lsc_planner_tpu_torch.convert import esdf_from_numpy, esdf_to_numpy

    jm, tm = missions("make_circle_mission", 4)
    with pytest.raises(ValueError, match="planner mode lsc"):
        tgoal.GoalPlanner(tm, params(goal_mode=GoalMode.ORCA)[1])
    jo, to = params(goal_mode=GoalMode.ORCA, planner_mode=PlannerMode.ORCA)
    rng = np.random.default_rng(5)
    pos, goal = rng.normal(size=(4, 3)), rng.normal(size=(4, 3))
    vel = rng.normal(size=(4, 3))
    goal[0] = pos[0] + vel[0] * 0.5 + 0.01      # within 0.05 m: snaps
    kw = dict(pos=pos, vel=np.zeros((4, 3)), init_traj=None,
              desired_goal=goal, seq=np.int32(3), radius=np.full(4, 0.15),
              downwash=np.full(4, 2.0))
    planner = tgoal.GoalPlanner(tm, to)
    with pytest.raises(ValueError, match="computes none"):
        planner.plan(**{k: None if v is None else _t(v)
                        for k, v in kw.items()})
    j = jgoal.GoalPlanner(jm, jo).plan(
        **{k: None if v is None else jnp.asarray(v) for k, v in kw.items()},
        orca_vel=jnp.asarray(vel))
    t = planner.plan(**{k: None if v is None else _t(v)
                        for k, v in kw.items()}, orca_vel=_t(vel))
    for a, b in zip(t, j):
        _close(a, b)
    assert np.array_equal(t[0][0].numpy(), goal[0])
    jesdf = JESDF.from_boxes(np.array([[0.5, 0.5, 0.0, 1.0, 1.0, 2.5]]),
                             jm.world_min, jm.world_max)
    tesdf = esdf_from_numpy(esdf_to_numpy(jesdf), device="cpu")
    jp, tp = params()
    jg = jgoal.GoalPlanner(jm, jp, jesdf).grid_planner
    tg = tgoal.GoalPlanner(tm, tp, tesdf).grid_planner
    np.testing.assert_array_equal(tg.dims, jg.dims)
    assert tg.max_wavefront_iters == jg.max_wavefront_iters
    _close(tg._grid_pts, jg._grid_pts, 0.0)
    _close(tg.static_occupancy(0.15), jg.static_occupancy(0.15))
    jp, tp = params(grid_los_exact_castray=True)
    tg = tgoal.GoalPlanner(tm, tp, tesdf).grid_planner
    assert tg.castray_depth == jgoal.GoalPlanner(jm, jp, jesdf).grid_planner \
        .castray_depth


def _boxed_planners(rng, **kw):
    """Both packages' grid planners (f64) of a 4-agent circle among eight
    random boxes, with the exact castRay."""
    from lsc_planner_tpu.ops.grid_search import GridPlanner as JGrid
    from lsc_planner_tpu.world.esdf import ESDF as JESDF
    from lsc_planner_tpu_torch.convert import esdf_from_numpy, esdf_to_numpy
    from lsc_planner_tpu_torch.ops.grid_search import GridPlanner as TGrid

    jm, tm = missions("make_circle_mission", 4, radius=3.0,
                      world=(-5, -5, 0, 5, 5, 2.5))
    lo = rng.uniform([-4, -4, 0], [3, 3, 0.5], size=(8, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.3, 1.5, size=(8, 3))], 1)
    jesdf = JESDF.from_boxes(boxes, jm.world_min, jm.world_max,
                             dtype=jnp.float64)
    tesdf = esdf_from_numpy(esdf_to_numpy(jesdf), device="cpu",
                            dtype=torch.float64)
    jp, tp = params(grid_los_exact_castray=True, **kw)
    return (JGrid(jm, jp, esdf=jesdf, dtype=jnp.float64),
            TGrid(tm, tp, esdf=tesdf, dtype=torch.float64))


def test_ray_safe_bisect_matches_jax(rng):
    """The exact castRay DP on a boxed ESDF: equal bool for bool to the JAX
    package's (both outcomes occur), and the LOS goal it selects equal."""
    jg, tg = _boxed_planners(rng)
    N, P = 6, 9
    origin = rng.uniform([-4, -4, 0.3], [4, 4, 2.0], size=(N, 3))
    pts = rng.uniform([-4.5, -4.5, 0.2], [4.5, 4.5, 2.3], size=(N, P, 3))
    pts[:, 0] = origin + rng.normal(size=(N, 3)) * 0.2    # short rays
    radius = np.full(N, 0.15)
    ratios = np.asarray([1.5, 1.4, 1.3, 1.2, 1.1, 1.0])
    want = np.asarray(jg._ray_safe_bisect(*map(jnp.asarray, (
        pts, origin, radius, ratios))))
    got = tg._ray_safe_bisect(*map(_t, (pts, origin, radius, ratios)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size
    goal = rng.uniform([-4, -4, 0.5], [4, 4, 2.0], size=(N, 3))
    _close(tg.los_free_goal(_t(pts), _t(origin), _t(goal), _t(radius)),
           jg.los_free_goal(jnp.asarray(pts), jnp.asarray(origin),
                            jnp.asarray(goal), jnp.asarray(radius)), 0.0)


@pytest.mark.parametrize("inclusive", [False, True])
def test_audit_tables_equal(inclusive):
    ts_t = taudit._sample_times(0.1, 0.2, inclusive)
    np.testing.assert_array_equal(ts_t,
                                  jaudit._sample_times(0.1, 0.2, inclusive))
    np.testing.assert_array_equal(
        taudit._sample_weight_matrix(ts_t, 0.2, 5, 5),
        jaudit._sample_weight_matrix(ts_t, 0.2, 5, 5))


def test_audit_matches(rng):
    traj = _swarm(rng, 7) * 30.0            # world-scale coordinates
    radius = rng.uniform(0.1, 0.2, size=7)
    downwash = rng.uniform(1.5, 2.5, size=7)
    ts = taudit._sample_times(0.1, 0.2, inclusive=True)
    _close(taudit.positions_at(_t(traj), ts, 0.2),
           jaudit.positions_at(jnp.asarray(traj), ts, 0.2))
    pos = traj[:, 0, 0]
    _close(taudit.pairwise_safety_ratio(_t(pos), _t(radius), _t(downwash)),
           jaudit.pairwise_safety_ratio(jnp.asarray(pos), jnp.asarray(radius),
                                        jnp.asarray(downwash)))
    _close(taudit.step_safety_ratio(_t(traj), _t(radius), _t(downwash),
                                    0.2, 0.1, 0.2),
           jaudit.step_safety_ratio(jnp.asarray(traj), jnp.asarray(radius),
                                    jnp.asarray(downwash), 0.2, 0.1, 0.2))
    _close(taudit.step_distance(_t(traj), 0.2, 0.1, 0.2),
           jaudit.step_distance(jnp.asarray(traj), 0.2, 0.1, 0.2))


def test_precision_self_check_cpu():
    assert taudit.precision_self_check("cpu") < 1e-3
