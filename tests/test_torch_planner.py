"""Port parity: LSC planes, prediction, goal rule and the safety audit.

Stated tolerance: max abs diff <= 1e-9 (float64 on both sides).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_planner_tpu.config import GoalMode, Param
from lsc_planner_tpu.missions import make_circle_mission
from lsc_planner_tpu.planner import constraints as jcons
from lsc_planner_tpu.planner import goal as jgoal
from lsc_planner_tpu.planner import prediction as jpred
from lsc_planner_tpu.sim import audit as jaudit
from lsc_planner_tpu_torch.planner import constraints as tcons
from lsc_planner_tpu_torch.planner import goal as tgoal
from lsc_planner_tpu_torch.planner import prediction as tpred
from lsc_planner_tpu_torch.sim import audit as taudit

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
    mission = make_circle_mission(N, radius=1.0)
    p = Param(goal_mode=mode)
    traj = _swarm(rng, N)
    traj[3] = traj[2] + np.array([0.2, 0.1, 0.0])   # inside the back-away
    pos = traj[:, 0, 0]                             # distance of agent 2
    goals = np.asarray([a.goal for a in mission.agents])
    goals[:2] = pos[:2] + 0.05            # two agents near their goals
    radius = np.full(N, 0.15)
    kw = dict(pos=pos, vel=rng.normal(size=(N, 3)), init_traj=traj,
              desired_goal=goals, seq=np.int32(3), radius=radius,
              downwash=np.full(N, 2.0))
    j = jgoal.GoalPlanner(mission, p).plan(
        **{k: jnp.asarray(v) for k, v in kw.items()}, prev_traj=traj)
    t = tgoal.GoalPlanner(mission, p).plan(
        **{k: _t(v) for k, v in kw.items()}, prev_traj=_t(traj))
    for a, b in zip(t, j):
        _close(a, b)


def test_goal_planner_off_slice_raises():
    mission = make_circle_mission(4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgoal.GoalPlanner(mission, Param(goal_mode=GoalMode.RIGHT_HAND))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgoal.GoalPlanner(mission, Param(), esdf=object())


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
