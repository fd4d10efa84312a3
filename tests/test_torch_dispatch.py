"""Port parity for several cycles a dispatch: run(steps_per_dispatch=k),
make_scan_cycle, the corridor's face expansion and the IPM's exit read.

Stated tolerances (float64 unless stated):
  * run(steps_per_dispatch=8) against the port's own run() on the 6-agent
    circle of tests/test_simulator.py: the same iterations and flight
    time, distance within rtol 1e-12;
  * run(steps_per_dispatch=8) against the JAX package's on a 6-agent
    random mission (seed 0): the same iterations, distance within 1e-9
    relative.  Not on the circle: its mirror agents 1 and 5 tie in the
    priority rule at cycle 16 (their goal distances differ by -1.2e-11 m
    in JAX and +2.5e-11 m in the port, both within their 1e-10 m of each
    other), so the two packages fly it in 65 and 56 cycles, each package's
    fused run equal to its own per-cycle run;
  * make_scan_cycle(3) against three cycle() calls on a 4-agent forest
    (grid planner, wavefront, corridor): every state field and every
    stacked output bit for bit;
  * the plain face expansion (ops/corridor.py) against the JAX package's
    CorridorBuilder.expand_boxes, f32 and f64: equal boxes and flags;
  * _ipm with its exit read skipped (as under CUDA graph capture) against
    _ipm with it, on the factored path: every output bit for bit;
  * a cycle after a warm-up cycle makes no tensor from host data and reads
    no tensor back to the host outside the plain versions (the CPU
    witness of what a CUDA graph capture of the cycle refuses).
The port runs on the CPU: every simulator here is given device="cpu".
"""
import sys
import traceback

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lsc_planner_tpu import missions as jmis
from lsc_planner_tpu.config import GoalMode
from lsc_planner_tpu.sim.simulator import SyncSimulator as JSim
from lsc_planner_tpu.world import corridor as jcor
from lsc_planner_tpu.world.esdf import ESDF as JESDF
from lsc_planner_tpu_torch import missions as tmis
from lsc_planner_tpu_torch.config import GoalMode as TGoalMode
from lsc_planner_tpu_torch.config import Param
from lsc_planner_tpu_torch.config import PlannerMode as TPlannerMode
from lsc_planner_tpu_torch.config import PredictionMode as TPredictionMode
from lsc_planner_tpu_torch.ops import corridor as corridor_ops
from lsc_planner_tpu_torch.ops import qp
from lsc_planner_tpu_torch.sim.simulator import SyncSimulator as _TSim
from lsc_planner_tpu_torch.world import corridor as tcor
from lsc_planner_tpu_torch.world.esdf import ESDF as TESDF
from test_torch_cuda import CORRIDOR_WORLD as WORLD
from test_torch_cuda import corridor_case, factored_problem, forest_mission
from torch_parity import missions, params, torch_one_thread  # noqa: F401

CPU = torch.device("cpu")


def TSim(mission, param, **kw):
    return _TSim(mission, param, device=CPU, **kw)


def _circle6():
    return missions("make_circle_mission", 6, radius=3.0,
                    world=(-5, -5, 0, 5, 5, 2.5))


def bits(t):
    """t's bits as integers (NaNs compare too)."""
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def assert_bits_equal(a, b, what):
    assert (a is None) == (b is None), what
    if a is not None:
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert torch.equal(bits(a), bits(b)), what


# ------------------------------------------------------------- run / scan
def test_fused_run_matches_per_cycle_run():
    """As tests/test_simulator.py::test_fused_dispatch_matches_per_cycle
    holds the JAX package: the same finishing iteration and flight time,
    distance truncated at the finish cycle."""
    _, m = _circle6()
    _, p = params(goal_mode=GoalMode.PRIOR_BASED, qp_iterations=10)
    ref = TSim(m, p, dtype=torch.float64).run(max_iterations=120)
    fus = TSim(m, p, dtype=torch.float64).run(max_iterations=120,
                                              steps_per_dispatch=8)
    assert ref["iterations"] < 120
    assert fus["iterations"] == ref["iterations"]
    assert fus["total_flight_time"] == ref["total_flight_time"]
    assert not fus["is_collided"] and fus["safety_ratio_agent"] >= 1.0
    np.testing.assert_allclose(fus["total_flight_distance"],
                               ref["total_flight_distance"], rtol=1e-12)
    assert fus["qp_failures"] == 0
    assert fus["final_state"].pos.shape == (6, 3)


def test_fused_run_matches_jax_fused_run():
    """The port's run(steps_per_dispatch=8) against the JAX package's,
    on a mission with no mirror-symmetric priority tie (see the module
    docstring)."""
    jm, m = missions("make_random_mission", 6, world=(-5, -5, 0, 5, 5, 2.5),
                     seed=0)
    jp, p = params(goal_mode=GoalMode.PRIOR_BASED, qp_iterations=10)
    j = JSim(jm, jp, dtype=jnp.float64).run(max_iterations=120,
                                            steps_per_dispatch=8)
    t = TSim(m, p, dtype=torch.float64).run(max_iterations=120,
                                           steps_per_dispatch=8)
    assert j["iterations"] < 120
    assert t["iterations"] == j["iterations"]
    assert t["total_flight_time"] == j["total_flight_time"]
    assert t["is_collided"] == j["is_collided"]
    np.testing.assert_allclose(t["total_flight_distance"],
                               j["total_flight_distance"], rtol=1e-9)


def test_scan_cycle_matches_cycles_on_a_forest():
    """make_scan_cycle(3) against three cycle() calls, bit for bit, on
    a 4-agent forest whose cycles run the grid planner and the corridor;
    the stacked goal distances and cumulative distance included."""
    m = forest_mission(tmis, 3, 4, 12, WORLD)
    sim = TSim(m, params(goal_mode=GoalMode.PRIOR_BASED)[1],
               dtype=torch.float64)
    assert sim.corridor is not None
    state = sim.initial_state()
    state, _ = sim.cycle(state)
    multi = sim.make_scan_cycle(3)
    got, (info, goal_dist, cum_dist) = multi(state)
    want, infos = state, []
    for _ in range(3):
        want, i = sim.cycle(want)
        infos.append((i, (want.pos - want.desired_goal).norm(dim=-1).max(),
                      want.distance))
    for f, a, b in zip(want._fields, got, want):
        assert_bits_equal(a, b, f)
    for c, (i, gd, cd) in enumerate(infos):
        for f, a, b in zip(i._fields, info, i):
            assert_bits_equal(None if a is None else a[c], b, f"{f}[{c}]")
        assert_bits_equal(goal_dist[c], gd, f"max_goal_dist[{c}]")
        assert_bits_equal(cum_dist[c], cd, f"cum_distance[{c}]")
    assert info.safety_step_min.shape == (3,)
    assert info.qp_cost.shape == (3, 4)


@pytest.mark.parametrize("kw", [dict(log=object()),
                                dict(multisim_experiment=True),
                                dict(multisim_planning_rate=5.0)])
def test_fused_dispatch_rejects_host_work(kw):
    """tests/test_simulator.py::test_fused_dispatch_rejects_dynamic_
    obstacles: k > 1 cycles a dispatch refuse per-cycle host work (a log,
    experiment mode's pose injection and pacing, real-time pacing) with
    ValueError, as the JAX package's run does; stage profiles, taken after
    the run, are not refused (tests/test_torch_host.py).  Dynamic
    obstacles are refused too (tests/test_torch_dynamic.py)."""
    _, m = missions("make_circle_mission", 4, radius=3.0,
                    world=(-5, -5, 0, 5, 5, 2.5))
    pkw = {k: v for k, v in kw.items() if k.startswith("multisim")}
    sim = TSim(m, params(**pkw)[1], dtype=torch.float64)
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        sim.run(steps_per_dispatch=4,
                **{k: v for k, v in kw.items() if k not in pkw})
    with pytest.raises(ValueError):
        sim.make_scan_cycle(0)


# ------------------------------------------------------ corridor expansion
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", ["random", "empty", "boxed_in",
                                  "world_min"])
def test_plain_face_expansion_matches_jax(case, dtype):
    """CorridorBuilder.expand_boxes, whose face expansion on the CPU is
    ops/corridor.py::expand_boxes_plain, against the JAX package's
    vmapped while_loop: equal boxes and seed flags (a seed inside a tree's
    margin keeps its box).  An empty world grows each box to within a voxel
    of every world face; the boxed-in seeds stop inside the shell on all
    six sides."""
    _, boxes, pts, goals = corridor_case(case, jmis)
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    j = JESDF.from_boxes(boxes, WORLD[:3], WORLD[3:], resolution=0.1,
                         dtype=jdt)
    t = TESDF.from_boxes(boxes, WORLD[:3], WORLD[3:], resolution=0.1,
                         dtype=tdt, device="cpu")
    jb = jcor.CorridorBuilder(j, np.asarray(WORLD[:3]),
                              np.asarray(WORLD[3:]), 0.15, dtype=jdt)
    tb = tcor.CorridorBuilder(t, np.asarray(WORLD[:3]),
                              np.asarray(WORLD[3:]), 0.15, dtype=tdt)
    pts, goals = pts.astype(dtype), goals.astype(dtype)
    jres = jb.expand_boxes(jnp.asarray(pts), jnp.asarray(goals))
    tres = tb.expand_boxes(torch.as_tensor(pts), torch.as_tensor(goals))
    for a, b in zip(tres, jres):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    bmin, bmax, ok = (r.numpy() for r in tres)
    if case == "random":       # some seeds lie inside a tree's margin
        assert 0 < ok.sum() < len(ok)
    else:
        assert ok.all()
    if case == "empty":
        assert (bmin <= np.asarray(WORLD[:3]) + 0.1 + 1e-6).all()
        assert (bmax >= np.asarray(WORLD[3:]) - 0.1 - 1e-6).all()
    if case == "boxed_in":
        inner = np.array([[-0.6, -0.6, 0.65], [0.6, 0.6, 1.85]])
        assert (bmin >= inner[0] - 1e-6).all()
        assert (bmax <= inner[1] + 1e-6).all()
        assert ((bmax - bmin) > 0.5).all()
    if case == "world_min":
        assert (bmin[0] <= np.asarray(WORLD[:3]) + 1e-6).all()


def test_face_expansion_wrapper_checks_its_inputs():
    """The wrapper refuses what the kernel does not take, on either
    device: a wrong index dtype, a box shape, a bound dtype."""
    _, boxes, pts, goals = corridor_case("boxed_in", tmis)
    t = TESDF.from_boxes(boxes, WORLD[:3], WORLD[3:], resolution=0.1,
                         dtype=torch.float64, device="cpu")
    tb = tcor.CorridorBuilder(t, np.asarray(WORLD[:3]),
                              np.asarray(WORLD[3:]), 0.15,
                              dtype=torch.float64)
    p = torch.as_tensor(pts)
    lo, hi = tb.initial_box(p)
    ok = ~tb._obstructed(lo, hi)
    cand = tb._axis_order(lo, hi, torch.as_tensor(goals))
    wmin, wmax = tb._world_bounds(torch.float64)
    args = [lo, hi, cand, ok, tb.sat, tb._wmin32, wmin, wmax]
    got = corridor_ops.expand_boxes(*args)
    assert got[0].dtype == torch.int32 and got[0].shape == (2, 3)
    for k, bad in ((2, cand.to(torch.int32)), (0, lo[:, :2]),
                   (7, wmax.float())):
        a = list(args)
        a[k] = bad
        with pytest.raises(ValueError, match="expand_boxes"):
            corridor_ops.expand_boxes(*a)


# --------------------------------------------------------- the exit read
def test_ipm_without_exit_read_is_bit_equal(rng, monkeypatch):
    """The factored path with production tolerances: skipping the
    every-8-iterations exit read (as _ipm does while a CUDA graph is being
    captured) runs all 40 iterations yet gives the same bits: finished
    instances are frozen and the count is kept on the device."""
    args, kw = factored_problem(rng, 4, 5, torch.float64, CPU)
    calls = []
    factor_solve = qp.chol.chol_factor_solve

    def counted(H, r):
        calls.append(1)
        return factor_solve(H, r)
    monkeypatch.setattr(qp.chol, "chol_factor_solve", counted)
    ref = qp.solve_qp_lsc(*args, **kw)
    n_ref = len(calls)
    monkeypatch.setattr(qp, "_capturing", lambda device: True)
    got = qp.solve_qp_lsc(*args, **kw)
    assert 1 < int(ref.iters) < 40 and n_ref < 40
    assert len(calls) - n_ref == 40
    for f, a, b in zip(ref._fields, got, ref):
        assert_bits_equal(a, b, f)


# ------------------------------------------------- no host traffic a cycle
_aten = torch.ops.aten
_HOST = {_aten.lift_fresh.default, _aten._local_scalar_dense.default,
         _aten.nonzero.default, _aten.masked_select.default}


class HostTraffic(TorchDispatchMode):
    """Records each op that, on a CUDA tensor, would copy host data to the
    device (a tensor made from host data), read a value back (item, bool,
    tolist) or size its output by the data (nonzero, a boolean index),
    unless it runs inside a plain version (a function named *_plain, the
    CPU stand-in of a kernel)."""

    def __init__(self):
        super().__init__()
        self.events = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        host = func in _HOST
        if func in (_aten.index.Tensor, _aten.index_put.default,
                    _aten.index_put_.default):
            host = any(i is not None and i.dtype == torch.bool
                       for i in args[1])
        if host:
            f = sys._getframe()
            while f is not None and not f.f_code.co_name.endswith("_plain"):
                f = f.f_back
            if f is None:
                self.events.append(f"{func}:\n" + "".join(
                    traceback.format_stack(limit=10)[:-1]))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["circle_dense", "knn_factored_fused",
                                  "forest", "forest_castray",
                                  "forest_velocity", "bvc", "rsfc",
                                  "right_hand", "circle_2d_fused",
                                  "orca", "orca_goal", "orca_forest_2d"])
def test_a_cycle_makes_no_host_traffic(case, monkeypatch):
    """After one warm-up cycle (which makes every cached constant), a cycle
    creates no tensor from host data and reads nothing back, outside the
    plain versions that stand in for the kernels on the CPU: the dense and
    the factored (fused) QP rows, K-NN pruning, the grid planner (with the
    exact castRay too), the corridor, and the VELOCITY prediction's
    slow-down against the ESDF; and the BVC, reciprocal RSFC (the slack
    QP) and right-hand modes, and a 2-D world through the fused IPM; the
    ORCA planner with the static and the ORCA goal modes, and in a 2-D
    forest with the grid goal rule.  The IPM's exit read is skipped as
    under graph capture."""
    circle = tmis.make_circle_mission(8, radius=3.0,
                                      world=(-5, -5, 0, 5, 5, 2.5))
    m, p = {
        "circle_dense": (circle, Param(goal_mode=TGoalMode.PRIOR_BASED)),
        "knn_factored_fused": (circle, Param(
            goal_mode=TGoalMode.PRIOR_BASED, max_neighbors=3,
            qp_fused_mode="on")),
        "forest": (forest_mission(tmis, 3, 4, 12, WORLD),
                   Param(goal_mode=TGoalMode.PRIOR_BASED)),
        "forest_castray": (forest_mission(tmis, 3, 4, 12, WORLD),
                           Param(goal_mode=TGoalMode.PRIOR_BASED,
                                 grid_los_exact_castray=True)),
        "forest_velocity": (forest_mission(tmis, 3, 4, 12, WORLD),
                            Param(goal_mode=TGoalMode.PRIOR_BASED,
                                  world_use_octomap=True)),
        "bvc": (circle, Param(goal_mode=TGoalMode.PRIOR_BASED,
                              planner_mode=TPlannerMode.BVC)),
        "rsfc": (circle, Param(goal_mode=TGoalMode.PRIOR_BASED,
                               planner_mode=TPlannerMode.RECIPROCAL_RSFC)),
        "right_hand": (circle, Param(goal_mode=TGoalMode.RIGHT_HAND)),
        "circle_2d_fused": (circle, Param(
            goal_mode=TGoalMode.PRIOR_BASED, world_dimension=2,
            world_z_2d=1.0, qp_fused_mode="on")),
        "orca": (circle, Param(goal_mode=TGoalMode.STATIC,
                               planner_mode=TPlannerMode.ORCA)),
        "orca_goal": (circle, Param(goal_mode=TGoalMode.ORCA,
                                    planner_mode=TPlannerMode.ORCA)),
        "orca_forest_2d": (forest_mission(tmis, 3, 4, 12, WORLD),
                           Param(goal_mode=TGoalMode.PRIOR_BASED,
                                 planner_mode=TPlannerMode.ORCA,
                                 world_dimension=2, world_z_2d=1.0)),
    }[case]
    monkeypatch.setattr(qp, "_capturing", lambda device: True)
    sim = TSim(m, p, dtype=torch.float32)
    if case == "forest_velocity":
        sim.param.prediction_mode = TPredictionMode.VELOCITY
    state, _ = sim.cycle(sim.initial_state())
    with HostTraffic() as h:
        sim.cycle(state)
    assert not h.events, "\n".join(h.events[:3])
