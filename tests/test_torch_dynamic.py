"""Port parity for mission dynamic obstacles and the prediction modes.

The same mission and Param go through the JAX package's SyncSimulator.run
and the port's (CPU, float64, qp_iterations 12 as in
tests/test_dynamic_obstacles.py), each cycle recorded on both sides.
Stated tolerance: every cycle's trajectories within 1e-6 m of JAX, and the
obstacle audit (a distance over summed radii of ~0.45 m) within 1e-6; the
prediction and initial trajectories of one state within 1e-12.  The
prediction mode is set after validated(), as the JAX package's tests set
it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_planner_tpu import missions as jmis
from lsc_planner_tpu.config import GoalMode, PredictionMode
from lsc_planner_tpu.sim.simulator import SyncSimulator as JSim
from lsc_planner_tpu_torch import missions as tmis
from lsc_planner_tpu_torch.sim.simulator import SyncSimulator as TSim
from torch_parity import params, port_value, torch_one_thread  # noqa: F401

CYCLES = 10


def dyn2(mis, extra=()):
    """tests/test_dynamic_obstacles.py's mission: two agents swapping
    across a spinning and a straight obstacle, built with `mis`'s
    classes; `extra` appends more ObstacleSpec keyword sets."""
    agents = []
    for qi, (s, g) in enumerate([((-3.0, 0.5, 1.0), (3.0, 0.5, 1.0)),
                                 ((3.0, -0.5, 1.0), (-3.0, -0.5, 1.0))]):
        a = mis.AgentSpec(id=qi, cid=qi + 1)
        a.start, a.goal = np.asarray(s), np.asarray(g)
        agents.append(a)
    specs = [
        dict(kind="spin", size=0.3, max_acc=2.0, downwash=1.0,
             axis_position=np.array([0.0, 2.0, 1.0]),
             axis_ori=np.array([0.0, 0.0, 1.0]),
             start=np.array([0.0, 3.0, 1.0]), speed=0.5),
        dict(kind="straight", size=0.25, max_acc=1.0, downwash=1.0,
             start=np.array([0.0, -3.0, 1.0]),
             goal=np.array([0.0, 3.0, 1.0]), speed=0.2),
        *extra]
    return mis.Mission(world_min=np.array([-5.0, -5, 0]),
                       world_max=np.array([5.0, 5, 2.5]), agents=agents,
                       obstacles=[mis.ObstacleSpec(**kw) for kw in specs],
                       mission_file_name="dyn2")


def fly_both(jm, tm, mode, cycles=CYCLES, **kw):
    """Both packages' run() of `cycles` cycles in f64 under prediction
    mode `mode`; returns (JAX trajs, port trajs, JAX summary, port
    summary), the trajectories (cycles, N, M, n+1, 3), and the two
    simulators."""
    jp, tp = params(goal_mode=GoalMode.STATIC, qp_iterations=12, **kw)
    jsim = JSim(jm, jp, dtype=jnp.float64)
    tsim = TSim(tm, tp, device="cpu", dtype=torch.float64)
    jsim.param.prediction_mode = mode
    tsim.param.prediction_mode = port_value(mode)
    jt, tt = [], []

    def jcycle(state, *dyn):
        out = jsim._cycle_jit(state, *dyn)
        jt.append(np.asarray(out[0].traj))
        return out
    tcycle = tsim.cycle

    def trec(state, *dyn):
        out = tcycle(state, *dyn)
        tt.append(out[0].traj.numpy().copy())
        return out
    tsim.cycle = trec
    js = jsim.run(max_iterations=cycles, cycle_fn=jcycle)
    ts = tsim.run(max_iterations=cycles)
    return np.stack(jt), np.stack(tt), js, ts, (jsim, tsim)


def check(jt, tt, js, ts, sims=None):
    """Every cycle's trajectories within 1e-6 m, the obstacle audit within
    1e-6, and the port's run safe."""
    assert jt.shape == tt.shape
    err = np.abs(tt - jt).reshape(len(jt), -1).max(-1)
    assert err.max() <= 1e-6, err
    assert abs(ts["safety_ratio_obs"] - js["safety_ratio_obs"]) <= 1e-6
    assert ts["safety_ratio_agent"] >= 1.0 and ts["qp_failures"] == 0


@pytest.mark.parametrize("mode,noise", [
    (PredictionMode.PREVIOUS_SOLUTION, 0.0),
    (PredictionMode.VELOCITY, 0.0),
    (PredictionMode.ORACLE, 0.0),
    (PredictionMode.LINEAR_KALMAN_FILTER, 0.0),
    (PredictionMode.LINEAR_KALMAN_FILTER, 0.02),
])
def test_dyn2_cycles_match_jax(mode, noise):
    check(*fly_both(dyn2(jmis), dyn2(tmis), mode, obs_observer_stddev=noise))


def test_velocity_slowdown_matches_jax(monkeypatch):
    """An obstacle head-on to agent 0: under VELOCITY prediction the
    linear-prediction slow-down contracts the trajectories (alpha < 1)."""
    from lsc_planner_tpu_torch.planner import prediction as tpred

    head = dict(kind="straight", size=0.2, max_acc=1.0, downwash=1.0,
                start=np.array([-0.5, 0.5, 1.0]),
                goal=np.array([-4.5, 0.5, 1.0]), speed=0.5)
    alphas = []
    slowdown = tpred.linear_prediction_slowdown

    def rec(*a, **kw):
        alpha = slowdown(*a, **kw)
        alphas.append(float(alpha.min()))
        return alpha
    monkeypatch.setattr(tpred, "linear_prediction_slowdown", rec)
    check(*fly_both(dyn2(jmis, [head]), dyn2(tmis, [head]),
                    PredictionMode.VELOCITY))
    assert min(alphas) < 0.5, alphas


def test_chasing_obstacle_matches_jax():
    """A chasing obstacle pursues the agent nearest to it, read back from
    the state each cycle."""
    chase = dict(kind="chasing", size=0.2, max_acc=1.0, downwash=1.0,
                 start=np.array([1.0, 2.5, 1.0]), max_vel=0.4,
                 gamma_target=0.5, gamma_obs=1.0)
    out = fly_both(dyn2(jmis, [chase]), dyn2(tmis, [chase]),
                   PredictionMode.PREVIOUS_SOLUTION)
    check(*out)
    jsim, tsim = out[-1]
    j, t = (s.obstacle_generator.models[2] for s in (jsim, tsim))
    np.testing.assert_allclose(t.pos, j.pos, rtol=0, atol=1e-9)
    np.testing.assert_allclose(t.goal_point, j.goal_point, rtol=0, atol=1e-9)
    assert np.linalg.norm(t.pos - chase["start"]) > 0.05    # it moved


def test_knn_with_dynamic_obstacles_matches_jax():
    """K-NN pruning (K = 3 of 6): the dynamic obstacles' columns follow the
    K neighbours' (C = K + O_dyn)."""
    def mission(mis):
        m = mis.make_circle_mission(6, radius=2.5,
                                    world=(-5, -5, 0, 5, 5, 2.5))
        m.obstacles = dyn2(mis).obstacles
        return m
    check(*fly_both(mission(jmis), mission(tmis),
                    PredictionMode.PREVIOUS_SOLUTION, cycles=6,
                    max_neighbors=3))


def test_dynamic_obstacles_refuse_several_cycles_a_dispatch():
    sim = TSim(dyn2(tmis), params()[1], device="cpu", dtype=torch.float64)
    assert sim.O_dyn == 2
    with pytest.raises(ValueError, match="dynamic obstacles"):
        sim.run(steps_per_dispatch=4)
    with pytest.raises(ValueError, match="dynamic obstacles"):
        sim.make_scan_cycle(4)
    # the JAX package has no ORCA prediction mode either (it raises
    # NotImplementedError(mode))
    sim.param.prediction_mode = port_value(PredictionMode.ORCA)
    with pytest.raises(NotImplementedError, match="JAX package has no "
                                                  "such mode"):
        sim.cycle(sim.initial_state())


@pytest.mark.parametrize("pmode,imode", [
    ("POSITION", "PREVIOUS_SOLUTION"), ("VELOCITY", "VELOCITY"),
    ("ORACLE", "GREEDY"), ("PREVIOUS_SOLUTION", "SKIP"),
    ("LINEAR_KALMAN_FILTER", "POSITION")])
def test_predict_and_init_modes_match(rng, pmode, imode):
    """Each prediction and initial-trajectory mode the port takes, from one
    random swarm state (seq 3, so the shifts apply): (init, prediction)
    within 1e-12 of the JAX package's."""
    from lsc_planner_tpu.config import InitialTrajMode

    jp, tp = params(goal_mode=GoalMode.STATIC)
    jsim = JSim(dyn2(jmis), jp, dtype=jnp.float64)
    tsim = TSim(dyn2(tmis), tp, device="cpu", dtype=torch.float64)
    for sim in (jsim, tsim):
        cfg = type(sim.param.prediction_mode)
        sim.param.prediction_mode = cfg[pmode]
        sim.param.initial_traj_mode = type(sim.param.initial_traj_mode)[
            imode]
    assert jsim.param.initial_traj_mode == InitialTrajMode[imode]
    traj = rng.normal(size=(2, 5, 6, 3))
    pos, vel, goal = (rng.normal(size=(2, 3)) for _ in range(3))
    want = jsim.predict_and_init(jnp.asarray(traj), jnp.asarray(pos),
                                 jnp.asarray(vel), jnp.asarray(3),
                                 prev_goal=jnp.asarray(goal))
    got = tsim.predict_and_init(*(torch.as_tensor(a) for a in (
        traj, pos, vel)), torch.tensor(3), prev_goal=torch.as_tensor(goal))
    for a, b in zip(got, want):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-12
