"""Port parity for the slice as a whole: the simulator cycle and run().

Stated tolerances: one full cycle from the same converted state (after 5
JAX cycles of an 8-agent circle, float64): traj max abs <= 1e-6 m.  The
f32 behaviour run (8-agent circle, radius 3, world +-5, PRIOR_BASED) must
finish with safety >= 1.0, and its cycle count must lie within
max(20 %, 10 cycles) of the JAX CPU float32 run of the same mission.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_planner_tpu.config import GoalMode, Param, PlannerMode
from lsc_planner_tpu.missions import ObstacleSpec, make_circle_mission
from lsc_planner_tpu.sim.simulator import SyncSimulator as JSim
from lsc_planner_tpu_torch.convert import state_from_numpy, state_to_numpy
from lsc_planner_tpu_torch.ops import chol
from lsc_planner_tpu_torch.sim.simulator import SyncSimulator as TSim


def _mission(qn=8):
    return make_circle_mission(qn, radius=3.0, world=(-5, -5, 0, 5, 5, 2.5))


def _to_numpy(state):
    return {k: (None if v is None else np.asarray(v))
            for k, v in state._asdict().items()}


def test_initial_state_equal():
    p = Param(goal_mode=GoalMode.PRIOR_BASED)
    j = _to_numpy(JSim(_mission(), p, dtype=jnp.float64).initial_state())
    t = state_to_numpy(TSim(_mission(), p, dtype=torch.float64)
                       .initial_state())
    assert j.keys() == t.keys()
    for k in j:
        if j[k] is None:
            assert t[k] is None, k
        else:
            assert j[k].dtype == t[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_state_round_trip():
    sim = TSim(_mission(), Param(), dtype=torch.float64)
    state, _ = sim.cycle(sim.initial_state())
    d = state_to_numpy(state)
    back = state_from_numpy(d, dtype=torch.float64)
    for a, b in zip(state, back):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("goal_mode", [GoalMode.PRIOR_BASED,
                                       GoalMode.STATIC])
def test_full_cycle_matches_from_converted_state(goal_mode):
    p = Param(goal_mode=goal_mode)
    jsim = JSim(_mission(), p, dtype=jnp.float64)
    tsim = TSim(_mission(), p, dtype=torch.float64)
    state = jsim.initial_state()
    for _ in range(5):
        state, _ = jsim._cycle_jit(state)
    j1, jinfo = jsim._cycle_jit(state)
    t1, tinfo = tsim.cycle(state_from_numpy(_to_numpy(state),
                                            dtype=torch.float64))
    assert np.abs(t1.traj.numpy() - np.asarray(j1.traj)).max() <= 1e-6
    jd, td = _to_numpy(j1), state_to_numpy(t1)
    for k in ("pos", "vel", "acc", "current_goal", "seq", "stall_count",
              "rescue_goal", "rescue_active", "rescue_phase",
              "best_goal_dist", "path_floor"):
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    for k in ("safety_agent_min", "distance", "qp_cost", "primal_res"):
        np.testing.assert_allclose(td[k], jd[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    np.testing.assert_array_equal(tinfo.qp_failed.numpy(),
                                  np.asarray(jinfo.qp_failed))
    assert int(tinfo.qp_iters) == int(jinfo.qp_iters)


def test_circle8_f32_run_matches_jax_behaviour():
    p = Param(goal_mode=GoalMode.PRIOR_BASED)
    j = JSim(_mission(), p, dtype=jnp.float32).run()
    chol.reset_counts()
    t = TSim(_mission(), p, dtype=torch.float32).run()
    assert j["iterations"] < p.multisim_max_planner_iteration
    assert t["iterations"] < p.multisim_max_planner_iteration
    assert np.isfinite(t["total_flight_time"])
    assert t["safety_ratio_agent"] >= 1.0 and not t["is_collided"]
    assert t["qp_failures"] == 0
    band = max(0.2 * j["iterations"], 10)
    assert abs(t["iterations"] - j["iterations"]) <= band, \
        (t["iterations"], j["iterations"])
    pos = t["final_state"].pos
    assert pos.dtype == torch.float32 and torch.isfinite(pos).all()
    # the CPU path runs the plain versions, which never count
    assert chol.factor_solve_launches == 0 and chol.resolve_launches == 0


def _knn_mission():
    return make_circle_mission(12, radius=2.0, world=(-4, -4, 0, 4, 4, 2.5))


def test_knn_cycle_matches_from_converted_state():
    """K-NN pruning (K = 4 of 12): one full f64 cycle from the state after
    3 JAX cycles gives the same trajectories (<= 1e-6 m), the same overflow
    flags and, at that state and at the tie-laden start of the circle, the
    same neighbours as lax.top_k."""
    import jax

    from lsc_planner_tpu_torch.sim.simulator import knn_select

    p = Param(goal_mode=GoalMode.PRIOR_BASED, max_neighbors=4)
    jsim = JSim(_knn_mission(), p, dtype=jnp.float64)
    tsim = TSim(_knn_mission(), p, dtype=torch.float64)
    state = jsim.initial_state()
    states = [state]
    for _ in range(3):
        state, _ = jsim._cycle_jit(state)
    states.append(state)
    j1, jinfo = jsim._cycle_jit(state)
    t1, tinfo = tsim.cycle(state_from_numpy(_to_numpy(state),
                                            dtype=torch.float64))
    assert np.abs(t1.traj.numpy() - np.asarray(j1.traj)).max() <= 1e-6
    np.testing.assert_array_equal(tinfo.knn_overflow.numpy(),
                                  np.asarray(jinfo.knn_overflow))
    eye = np.eye(12, dtype=bool)
    for s in states:
        pos = np.array(jsim.propagate(s)[0])
        d2 = jnp.sum((pos[None, :, :] - pos[:, None, :]) ** 2, axis=-1)
        _, j_nbr = jax.lax.top_k(-jnp.where(eye, jnp.inf, d2), 4)
        _, t_nbr = knn_select(torch.as_tensor(pos), torch.as_tensor(pos),
                              torch.as_tensor(eye), 4)
        np.testing.assert_array_equal(t_nbr.numpy(), np.asarray(j_nbr))


@pytest.mark.parametrize("ring", ["tight", "sparse"])
def test_knn_overflow_audit_matches_jax(ring):
    """The two rings of test_simulator.py:208-236 (K = 3 of 8): the tight
    ring flags every agent, the sparse one none and stays finite; the port
    gives JAX's flags."""
    import math

    p = Param(goal_mode=GoalMode.PRIOR_BASED, qp_iterations=14,
              max_neighbors=3)
    r = 1.0 if ring == "tight" else 8.0 / (2 * math.sin(math.pi / 8))
    ring_kw = dict(radius=r, world=(-r - 2, -r - 2, 0, r + 2, r + 2, 2.5))
    jsim = JSim(make_circle_mission(8, **ring_kw), p, dtype=jnp.float64)
    _, jinfo = jsim._cycle_jit(jsim.initial_state())
    tsim = TSim(make_circle_mission(8, **ring_kw), p, dtype=torch.float64)
    tstate, tinfo = tsim.cycle(tsim.initial_state())
    flags = tinfo.knn_overflow.numpy()
    np.testing.assert_array_equal(flags, np.asarray(jinfo.knn_overflow))
    assert flags.all() if ring == "tight" else not flags.any()
    assert torch.isfinite(tstate.traj).all()


@pytest.mark.parametrize("change,item", [
    (dict(planner_mode=PlannerMode.BVC), "items 12-13"),
    (dict(world_use_octomap=True), "item 10"),
    (dict(multisim_experiment=True), "item 12"),
    (dict(goal_mode=GoalMode.ORCA), "items 12-13"),
    (dict(world_dimension=2), "item 12"),
])
def test_off_slice_raises(change, item):
    with pytest.raises(NotImplementedError, match=item):
        TSim(_mission(), Param(**change))


def test_obstacles_and_fused_dispatch_raise():
    m = _mission()
    m.obstacles = [ObstacleSpec(kind="static", pose=np.zeros(3),
                                dimensions=np.ones(3))]
    with pytest.raises(NotImplementedError, match="item 10"):
        TSim(m, Param())
    m.obstacles = [ObstacleSpec(kind="straight")]
    with pytest.raises(NotImplementedError, match="item 12"):
        TSim(m, Param())
    sim = TSim(_mission(4), Param())
    with pytest.raises(NotImplementedError, match="item 7"):
        sim.run(steps_per_dispatch=2)
    with pytest.raises(ValueError, match="qp_fused_mode"):
        TSim(_mission(4), Param(qp_fused_mode="interpret"))


def test_patrol_swap_and_finish_match():
    p = Param(multisim_patrol=True)
    jsim = JSim(_mission(), p, dtype=jnp.float64)
    tsim = TSim(_mission(), p, dtype=torch.float64)
    state = jsim.initial_state()
    pos = np.asarray(state.pos).copy()
    pos[[1, 5]] = np.asarray(state.desired_goal)[[1, 5]]    # two arrived
    j = jsim._patrol_swap(state, jnp.asarray(pos))
    t = tsim._patrol_swap(state_from_numpy(_to_numpy(state),
                                           dtype=torch.float64),
                          torch.as_tensor(pos))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not tsim.is_finished(tsim.initial_state())


def test_rescue_and_stall_bookkeeping_match(rng):
    """Engage, expire and hold branches of the deadlock rescue."""
    from lsc_planner_tpu.sim import simulator as jmod
    from lsc_planner_tpu_torch.sim import simulator as tmod

    p = Param()
    jsim = JSim(_mission(), p, dtype=jnp.float64)
    state = jsim.initial_state()
    N = 8
    d = {k: (None if v is None else v.copy())
         for k, v in _to_numpy(state).items()}
    d["stall_count"] = np.array([0, 7, 7, 3, 7, 0, 3, 7], np.int32)
    d["rescue_active"] = np.array([0, 0, 1, 1, 0, 1, 0, 0], bool)
    d["rescue_phase"] = np.array([0, 1, 2, 3, 4, 0, 1, 2], np.int32)
    d["rescue_goal"] = rng.normal(size=(N, 3))
    d["current_goal"] = d["desired_goal"] + rng.normal(size=(N, 3))
    d["path_floor"] = d["pos"] + rng.normal(size=(N, 3))
    jstate = state._replace(**{k: jnp.asarray(v) for k, v in d.items()
                               if v is not None})
    tstate = state_from_numpy(d, dtype=torch.float64)
    pos = d["pos"] + rng.normal(size=(N, 3)) * 0.05
    vel = rng.normal(size=(N, 3)) * 0.05
    best = np.full(N, np.inf)
    best[:3] = 0.5
    j_sc = jmod._update_stall_count(
        jnp.asarray(d["stall_count"]), jnp.asarray(best),
        jnp.asarray(d["pos"]), jnp.asarray(pos), jnp.asarray(vel),
        jnp.asarray(d["desired_goal"]), jnp.asarray(4, jnp.int32), p)
    t_sc = tmod._update_stall_count(
        torch.as_tensor(d["stall_count"]), torch.as_tensor(best),
        torch.as_tensor(d["pos"]), torch.as_tensor(pos),
        torch.as_tensor(vel), torch.as_tensor(d["desired_goal"]),
        torch.tensor(4, dtype=torch.int32), p)
    for a, b in zip(t_sc, j_sc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    j_r = jmod._update_rescue(
        jstate, jnp.asarray(pos), jstate.desired_goal, j_sc[0], j_sc[1], p,
        radius=jsim.radius, world_min=jsim.world_min,
        world_max=jsim.world_max, progress_best=j_sc[2])
    tsim = TSim(_mission(), p, dtype=torch.float64)
    t_r = tmod._update_rescue(
        tstate, torch.as_tensor(pos), tstate.desired_goal, t_sc[0],
        t_sc[1], p, radius=tsim.radius, world_min=tsim.world_min,
        world_max=tsim.world_max, progress_best=t_sc[2])
    for a, b in zip(t_r, j_r):
        a, b = a.numpy(), np.asarray(b)
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b)
        else:
            assert np.abs(a - b).max() <= 1e-9
    assert bool(np.asarray(j_r[1]).any())       # some rescue engaged/held
