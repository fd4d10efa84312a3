"""Port parity: the wavefront grid planner and the obstacle-world cycle.

The same numpy inputs go through the JAX function (CPU, float64 under
conftest unless stated) and its PyTorch counterpart.  Stated tolerances:
  * the wavefront plain version against the JAX TPU kernel in interpret
    mode: bit-exact, also where the cap ends the loop; converged fields
    equal GridPlanner.wavefront's (which runs a fixed step count);
  * GridPlanner.plan_goals: LOS goal and path floor within 1e-9;
  * one full f64 cycle of a 4-agent forest from a converted state: traj
    within 1e-6 m, the SFC boxes equal;
  * the 2-agent wall mission of test_static_obstacles.py flown in f32:
    finished, agent and obstacle safety >= 1, cycles within max(20 %, 10)
    of the JAX package's f64 run, whose count the port's f64 run matches
    exactly.  The yardstick is f64 because f32 rounding alone moves this
    mission's cycle count far: at qp_iterations 20 the JAX package needs
    111 cycles in f64 and 151 in f32, the port 111 in f64 and 114 in f32.
    test_torch_f32_missions.py holds f32 runs to JAX's f32 runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_planner_tpu import missions as jmis
from lsc_planner_tpu.config import GoalMode
from lsc_planner_tpu.ops.grid_search import GridPlanner as JGrid
from lsc_planner_tpu.ops.wavefront_pallas import wavefront_batched as jwave
from lsc_planner_tpu.sim.simulator import SyncSimulator as JSim
from lsc_planner_tpu.world.esdf import ESDF as JESDF
from lsc_planner_tpu_torch import missions as tmis
from lsc_planner_tpu_torch.convert import (esdf_from_numpy, esdf_to_numpy,
                                           state_from_numpy, state_to_numpy)
from lsc_planner_tpu_torch.ops import wavefront
from lsc_planner_tpu_torch.ops.grid_search import GridPlanner as TGrid
from lsc_planner_tpu_torch.sim.simulator import SyncSimulator as TSim
from test_torch_cuda import forest_mission
from torch_parity import missions, params, torch_one_thread  # noqa: F401

WORLD = (-3.0, -3.0, 0.0, 3.0, 3.0, 2.5)
CPU = torch.device("cpu")


def _t(a):
    return torch.as_tensor(np.array(a))


def _grids(rng, N=3, Z=5, Y=21, X=21, fill=0.25):
    """Random occupancy with unreachable pockets; agent 0's goal cell is
    occupied (the kernel frees it) and agent 2's is walled in."""
    occ = (rng.uniform(size=(N, Z, Y, X)) < fill).astype(np.float32)
    goal = np.stack([rng.integers(0, Z, N), rng.integers(0, Y, N),
                     rng.integers(0, X, N)], -1).astype(np.int32)
    occ[0, goal[0, 0], goal[0, 1], goal[0, 2]] = 1.0
    z, y, x = goal[2]
    for dz, dy, dx in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                       (0, 0, 1), (0, 0, -1)):
        if 0 <= z + dz < Z and 0 <= y + dy < Y and 0 <= x + dx < X:
            occ[2, z + dz, y + dy, x + dx] = 1.0
    return occ, goal


@pytest.mark.parametrize("max_iters", [8, 13, 70])
def test_wavefront_plain_bit_exact_vs_interpret(rng, max_iters):
    occ, goal = _grids(rng)
    want = np.asarray(jwave(jnp.asarray(occ), jnp.asarray(goal),
                            max_iters=max_iters, interpret=True))
    got, steps = wavefront.wavefront_batched_plain(_t(occ), _t(goal),
                                                   max_iters)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0].min() == 0.0 and (got == wavefront.BIG).any()
    cap = -(-max_iters // 8) * 8
    if max_iters < 70:      # the cap ends the loop: fields not converged
        assert steps.tolist() == [cap, cap, 8]
        assert bool((got[1] > 1e6).sum() > (occ[1] > 0.5).sum())
    else:
        assert int(steps.max()) < max_iters
    np.testing.assert_array_equal(
        wavefront.wavefront_batched(_t(occ), _t(goal), max_iters).numpy(),
        want)


def test_wavefront_converged_equals_grid_planner(rng):
    """GridPlanner.wavefront runs max_wavefront_iters (70 here) steps with
    no early exit and inf for unreachable cells: once the field has
    converged below the cap, wavefront_distance gives the same field."""
    jm, _ = missions("make_circle_mission", 2, radius=1.0,
                     world=(0.0, 0.0, 0.0, 5.0, 5.0, 1.0))
    jp, _ = params()
    jg = JGrid(jm, jp, None)
    assert tuple(jg.dims) == (21, 21, 5) and jg.max_wavefront_iters == 70
    occ, goal = _grids(rng)
    occ_xyz = np.transpose(occ, (0, 3, 2, 1)) > 0.5
    goal_xyz = goal[:, ::-1].copy()
    want = np.asarray(jax.vmap(jg.wavefront)(jnp.asarray(occ_xyz),
                                             jnp.asarray(goal_xyz)))
    got = wavefront.wavefront_distance(_t(occ_xyz), _t(goal_xyz),
                                       max_iters=70)
    steps = wavefront.wavefront_batched_steps(_t(occ), _t(goal), 70)[1]
    assert int(steps.max()) < 70
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isinf(want).any()


def _forest(seed=3, qn=4, n_trees=12):
    return (forest_mission(jmis, seed, qn, n_trees, WORLD),
            forest_mission(tmis, seed, qn, n_trees, WORLD))


def _boxes(m):
    return np.stack([np.concatenate([o.pose - o.dimensions,
                                     o.pose + o.dimensions])
                     for o in m.obstacles])


def test_plan_goals_matches(rng):
    jm, tm = _forest()
    jp, tp = params(goal_mode=GoalMode.PRIOR_BASED)
    jesdf = JESDF.from_boxes(_boxes(jm), WORLD[:3], WORLD[3:],
                             dtype=jnp.float64)
    jg = JGrid(jm, jp, jesdf, dtype=jnp.float64)
    tg = TGrid(tm, tp, esdf_from_numpy(esdf_to_numpy(jesdf), device=CPU,
                                       dtype=torch.float64),
               dtype=torch.float64)
    N = 4
    pos = np.stack([a.start for a in jm.agents])
    goal = np.stack([a.goal for a in jm.agents])
    # agent 3 starts on a tree's margin: occupied-start recovery
    pos[3] = jm.obstacles[0].pose + np.array([0.2, 0.0, 0.0])
    init_end = pos + rng.normal(size=(N, 3)) * 0.1
    radius = np.full(N, 0.15)
    downwash = np.full(N, 2.0)
    higher = rng.uniform(size=(N, N)) < 0.5
    np.fill_diagonal(higher, False)
    args = (pos, init_end, goal, radius, downwash, pos, radius, downwash,
            higher)
    j = jg.plan_goals(*map(jnp.asarray, args))
    t = tg.plan_goals(*map(_t, args))
    for a, b in zip(t, j):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-9
    # the pieces: occupancy, start recovery, descent
    occ_t = tg.occupancy(*map(_t, (radius, downwash, pos, radius, downwash,
                                   higher)))
    occ_j = jg.occupancy(*map(jnp.asarray, (radius, downwash, pos, radius,
                                            downwash, higher)))
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
    start = tg.to_cell(_t(pos))
    np.testing.assert_array_equal(
        tg.recover_start(occ_t, start).numpy(),
        np.asarray(jax.vmap(jg.recover_start)(occ_j, jnp.asarray(start))))
    np.testing.assert_array_equal(
        tg.cast_ray(_t(pos), _t(goal), _t(radius)).numpy(),
        np.asarray(jg.cast_ray(jnp.asarray(pos), jnp.asarray(goal),
                               jnp.asarray(radius))))


def _to_numpy(state):
    return {k: (None if v is None else np.asarray(v))
            for k, v in state._asdict().items()}


def test_forest_cycle_matches_from_converted_state():
    """Three JAX cycles of a 4-agent forest, then one cycle on each side
    from the converted state (f64): traj within 1e-6 m, SFC boxes equal."""
    jm, tm = _forest()
    jp, tp = params(goal_mode=GoalMode.PRIOR_BASED)
    jsim = JSim(jm, jp, dtype=jnp.float64)
    tsim = TSim(tm, tp, device=CPU, dtype=torch.float64)
    np.testing.assert_array_equal(esdf_to_numpy(tsim.esdf)["dist"],
                                  esdf_to_numpy(jsim.esdf)["dist"])
    state = jsim.initial_state()
    for _ in range(3):
        state, _ = jsim._cycle_jit(state)
    j1, jinfo = jsim._cycle_jit(state)
    t1, tinfo = tsim.cycle(state_from_numpy(_to_numpy(state),
                                            dtype=torch.float64))
    jd, td = _to_numpy(j1), state_to_numpy(t1)
    assert np.abs(td["traj"] - jd["traj"]).max() <= 1e-6
    np.testing.assert_array_equal(td["sfc"], jd["sfc"])
    for k in ("current_goal", "path_floor", "rescue_goal", "stall_count",
              "sfc_initialized"):
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    np.testing.assert_allclose(td["safety_obs_min"], jd["safety_obs_min"],
                               rtol=1e-12)
    np.testing.assert_array_equal(tinfo.qp_failed.numpy(),
                                  np.asarray(jinfo.qp_failed))


def _wall_missions():
    """test_static_obstacles.py:23-30 on each side."""
    out = []
    for mis in (jmis, tmis):
        m = mis.make_square_mission(2, half=3.0, world=(-5, -5, 0, 5, 5, 2.5))
        m.obstacles = [mis.ObstacleSpec(kind="static",
                                        pose=np.array([0.0, 0.0, 1.25]),
                                        dimensions=np.array([0.3, 2.0, 1.25]))]
        out.append(m)
    return out


def test_wall_mission_f32_run_matches_jax_behaviour():
    jm, tm = _wall_missions()
    jp, tp = params(goal_mode=GoalMode.PRIOR_BASED, qp_iterations=20)
    j = JSim(jm, jp, dtype=jnp.float64).run()
    wavefront.reset_counts()
    t = TSim(tm, tp, device=CPU, dtype=torch.float32).run()
    assert j["iterations"] < jp.multisim_max_planner_iteration
    assert t["iterations"] < tp.multisim_max_planner_iteration
    assert t["safety_ratio_agent"] >= 1.0 and not t["is_collided"]
    assert t["safety_ratio_obs"] >= 1.0
    assert t["qp_failures"] == 0
    assert t["total_flight_distance"] > 12.0       # routed around the wall
    band = max(0.2 * j["iterations"], 10)
    assert abs(t["iterations"] - j["iterations"]) <= band, \
        (t["iterations"], j["iterations"])
    # the yardstick's witness: in f64 the port flies the JAX run's count
    t64 = TSim(tm, tp, device=CPU, dtype=torch.float64).run()
    assert t64["iterations"] == j["iterations"]
    # the CPU path runs the plain version, which never counts
    assert wavefront.wavefront_launches == 0
