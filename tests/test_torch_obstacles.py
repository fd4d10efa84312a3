"""Port parity: the dynamic-obstacle models, the obstacle generator's noise,
the Kalman filter, and the prediction and audit helpers of the dynamic
path against the JAX package.

The host modules (sim/obstacles.py, sim/kalman.py) are the port's own
numpy copies: same inputs, same seeds, equal to the last bit (the
Bernstein obstacle, evaluated through another basis routine, within
1e-12).  The tensor helpers run in float64 on both sides, within 1e-12,
with inf where JAX has inf.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_planner_tpu import missions as jmis
from lsc_planner_tpu.ops import geometry as jgeo
from lsc_planner_tpu.planner import prediction as jpred
from lsc_planner_tpu.sim import audit as jaudit
from lsc_planner_tpu.sim import kalman as jkal
from lsc_planner_tpu.sim import obstacles as jobs
from lsc_planner_tpu_torch import missions as tmis
from lsc_planner_tpu_torch.ops import geometry as tgeo
from lsc_planner_tpu_torch.planner import prediction as tpred
from lsc_planner_tpu_torch.sim import audit as taudit
from lsc_planner_tpu_torch.sim import kalman as tkal
from lsc_planner_tpu_torch.sim import obstacles as tobs
from torch_parity import torch_one_thread  # noqa: F401

TOL = 1e-12
TIMES = np.linspace(0.0, 24.5, 50)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max(initial=0.0) <= tol


def _specs(csv_path):
    """One keyword set of every model kind."""
    return [
        dict(kind="spin", size=0.3, axis_position=np.array([0.5, 2.0, 1.0]),
             axis_ori=np.array([0.1, 0.2, 1.0]),
             start=np.array([0.5, 3.5, 1.2]), speed=0.5),
        dict(kind="straight", size=0.25, start=np.array([0.0, -3.0, 1.0]),
             goal=np.array([1.0, 3.0, 1.5]), speed=0.4),
        dict(kind="multisim_patrol", size=0.2,
             waypoints=np.array([[-2.0, 0, 1], [2.0, 0, 1], [2.0, 2, 1.5]]),
             speed=0.7),
        dict(kind="chasing", size=0.2, max_acc=1.5, start=np.array(
            [1.0, 1.0, 1.0]), max_vel=0.6, gamma_target=0.8, gamma_obs=2.0),
        dict(kind="gaussian", size=0.2, max_acc=1.0, max_vel=0.5,
             start=np.array([0.0, 0.0, 1.0]),
             initial_vel=np.array([0.1, -0.2, 0.0]), stddev_acc=0.6,
             acc_update_cycle=0.3),
        dict(kind="static", pose=np.array([1.0, 2.0, 1.0]),
             dimensions=np.array([0.2, 0.3, 1.0])),
        dict(kind="bernstein", size=0.2, traj_csv_path=csv_path, traj_n=5),
    ]


def _bernstein_csv(tmp_path, rng):
    """Three segments of a piecewise Bernstein trajectory in the
    reference's CSV layout (index, end time, x then y control points)."""
    rows = [[k, 1.5 * (k + 1), *rng.normal(size=12)] for k in range(3)]
    path = tmp_path / "obstacle.csv"
    np.savetxt(path, np.asarray(rows), delimiter=",",
               header="index,time,ctrl", comments="")
    return str(path)


def _missions(specs):
    def make(mis):
        m = mis.make_circle_mission(3)
        m.obstacles = [mis.ObstacleSpec(**kw) for kw in specs]
        return m
    return make(jmis), make(tmis)


@pytest.mark.parametrize("kind", ["spin", "straight", "multisim_patrol",
                                  "chasing", "gaussian", "static",
                                  "bernstein"])
def test_model_states_match(tmp_path, rng, kind):
    specs = [s for s in _specs(_bernstein_csv(tmp_path, rng))
             if s["kind"] == kind]
    jm, tm = _missions(specs)
    j, = jobs.build_models(jm, seed=3)
    t, = tobs.build_models(tm, seed=3)
    assert type(t).__name__ == type(j).__name__
    if kind == "chasing":       # pursue a goal past a repulsive obstacle
        for m in (j, t):
            m.set_goal_point([3.0, 2.0, 1.0])
            m.set_obstacles([(np.array([1.8, 1.4, 1.0]), 0.3)])
    tol = TOL if kind == "bernstein" else 0.0
    for time in TIMES:
        for got, want in zip(t.state(float(time)), j.state(float(time))):
            _close(got, np.asarray(want), tol)
    assert t.radius == j.radius and t.is_static == j.is_static


def test_generator_noise_and_attributes_match(tmp_path, rng):
    specs = [s for s in _specs(_bernstein_csv(tmp_path, rng))
             if s["kind"] != "static"]
    jm, tm = _missions(specs)
    j = jobs.ObstacleGenerator(jm, noise_std=0.05, seed=7)
    t = tobs.ObstacleGenerator(tm, noise_std=0.05, seed=7)
    for name in ("radii", "downwash", "max_acc"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    for time in TIMES[:20]:
        for got, want in zip(t.update(float(time)), j.update(float(time))):
            _close(got, want, TOL)
        _close(t.observed(), j.observed(), TOL)
        _close(t.observed(4), j.observed(4), TOL)


def test_kalman_filter_matches(rng):
    j = jkal.LinearKalmanFilter(5, 0.004, 0.02, 0.8)
    t = tkal.LinearKalmanFilter(5, 0.004, 0.02, 0.8)
    truth = rng.normal(size=(5, 3))
    vel = rng.normal(size=(5, 3)) * 0.5
    for k in range(30):
        time = 0.2 * k
        obs = truth + vel * time + rng.normal(size=(5, 3)) * 0.06
        for got, want in zip(t.filter(obs, time), j.filter(obs, time)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t.uncertainty_radius(1.0),
                                  j.uncertainty_radius(1.0))


def test_collision_time_linear_matches(rng):
    """Random pairs, plus the parallel, zero-length and already-inside cases
    where the quadratic degenerates."""
    B = 200
    a0, a1, o0, o1 = (rng.normal(size=(B, 3)) * 2.0 for _ in range(4))
    o1[:20] = o0[:20] + (a1[:20] - a0[:20])        # parallel: a = 0
    a1[20:30], o1[20:30] = a0[20:30], o0[20:30]    # zero-length paths
    o0[30:40] = a0[30:40] + 0.1                    # inside at t = 0
    R = rng.uniform(0.3, 1.5, size=B)
    got = tgeo.collision_time_linear(_t(o0), _t(o1), _t(a0), _t(a1), _t(R),
                                     1.0)
    want = jgeo.collision_time_linear(*map(jnp.asarray, (o0, o1, a0, a1, R)),
                                      1.0)
    _close(got, want)
    w = np.asarray(want)
    assert np.isinf(w[:30]).any() and np.isfinite(w).any() and \
        (w[30:40] == 0.0).all()


@pytest.mark.parametrize("with_esdf", [False, True])
def test_slowdown_and_contraction_match(rng, with_esdf):
    from lsc_planner_tpu.world.esdf import ESDF as JESDF
    from lsc_planner_tpu_torch.convert import esdf_from_numpy, esdf_to_numpy

    L, O, M, n1 = 5, 4, 5, 6
    # straight paths from starts close enough that some of them collide
    init = 0.6 * rng.normal(size=(L, 1, 1, 3)) + \
        np.linspace(0, 1, M * n1).reshape(1, M, n1, 1) * \
        rng.normal(size=(L, 1, 1, 3))
    obs = 0.6 * rng.normal(size=(L, O, 1, 1, 3)) + \
        np.linspace(0, 1, M * n1).reshape(1, 1, M, n1, 1) * \
        rng.normal(size=(L, O, 1, 1, 3))
    radius = rng.uniform(0.1, 0.3, size=L)
    obs_radius = rng.uniform(0.1, 0.3, size=(L, O))
    mask = rng.uniform(size=(L, O)) < 0.8
    jesdf = tesdf = None
    if with_esdf:
        jesdf = JESDF.from_boxes(
            np.array([[-0.5, -0.5, -0.5, 0.5, 0.5, 0.5]]), (-4, -4, -4),
            (4, 4, 4), resolution=0.2)
        tesdf = esdf_from_numpy(esdf_to_numpy(jesdf), device="cpu",
                                dtype=torch.float64)
    want = jpred.linear_prediction_slowdown(
        jnp.asarray(init), jnp.asarray(obs), jnp.asarray(radius),
        jnp.asarray(obs_radius), jnp.asarray(mask), 1.0, esdf=jesdf)
    got = tpred.linear_prediction_slowdown(
        _t(init), _t(obs), _t(radius), _t(obs_radius), _t(mask), 1.0,
        esdf=tesdf)
    _close(got, want)
    assert ((np.asarray(want) > 0.0) & (np.asarray(want) < 1.0)).any()
    _close(tpred.contract_trajectories(_t(obs), got[:, None]),
           jpred.contract_trajectories(jnp.asarray(obs), want[:, None]))
    _close(tpred.contract_trajectories(_t(init), got),
           jpred.contract_trajectories(jnp.asarray(init), want))


def test_constant_position_and_obstacle_audit_match(rng):
    pos = rng.normal(size=(4, 2, 3))
    _close(tpred.constant_position_traj(_t(pos), 5, 5),
           jpred.constant_position_traj(jnp.asarray(pos), 5, 5))
    p, o = rng.normal(size=(6, 3)) * 3, rng.normal(size=(3, 3)) * 3
    r, ro = rng.uniform(0.1, 0.2, size=6), rng.uniform(0.2, 0.4, size=3)
    _close(taudit.obstacle_safety_ratio(*map(_t, (p, o, r, ro))),
           jaudit.obstacle_safety_ratio(*map(jnp.asarray, (p, o, r, ro))))
