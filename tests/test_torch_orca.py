"""Port parity: the ORCA planner (ops/orca.py, the ORCA planner mode and
the ORCA goal mode) against the JAX package.

The same numpy inputs go through the JAX function (CPU, float64 under
conftest) and its PyTorch counterpart.  Stated tolerances: build_orca_planes,
the linear programs and solve_orca within 1e-12 in f64 (lp1's (ok, fail)
flags equal everywhere, its line point compared where the line is
feasible: on an infeasible line every caller discards it); solve_orca
within 1e-5 m/s in f32; one ORCA cycle from JAX's state within 1e-9 m in
each goal mode and in a 2-D world.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lsc_planner_tpu.config import GoalMode, PlannerMode
from lsc_planner_tpu.ops import orca as jorca
from lsc_planner_tpu.sim.simulator import SyncSimulator as JSim
from lsc_planner_tpu_torch.ops import orca as torca
from lsc_planner_tpu_torch.sim.simulator import SyncSimulator as _TSim
from torch_parity import (follow_jax, missions, params,  # noqa: F401
                          torch_one_thread)

TOL = 1e-12
N, O = 16, 10


def TSim(mission, param, **kw):
    return _TSim(mission, param, device="cpu", **kw)


def _t(a):
    return torch.as_tensor(np.array(a))


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def plane_case(kind, seed=0):
    """(normal, point, valid) numpy plane sets (N, O, ...) and the agent
    arrays they came from.

    "crowd": build_orca_planes of agents packed closer than their radii
    (the collision branch, infeasible LPs that need lp4).  "degenerate":
    the crowd's planes with plane 3 parallel to plane 1 (0.2 looser),
    plane 6 anti-parallel to it (a slab 0.8 wide), plane 5 within 1e-3 rad
    of plane 2 (0.2 tighter: lp2 on it meets plane 2 as a degenerate
    line), and the two planes that pin v_z in a 2-D world last.  No plane
    repeats another exactly: whether a result on a plane violates its copy
    is decided by rounding, and the JAX package's own jitted and eager lp4
    disagree by up to 1.04 m/s on such sets."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.6, 0.6, (N, 3))
    vel = rng.uniform(-1.0, 1.0, (N, 3))
    d2 = ((pos[None] - pos[:, None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nbr = np.argsort(d2, axis=1, kind="stable")[:, :O]
    dyn = rng.random(N) < 0.3
    r = np.full(N, 0.25)
    args = (pos, vel, r, pos[nbr], vel[nbr], r[nbr], dyn[nbr],
            np.take_along_axis(d2, nbr, 1) < 225.0)
    pl = jorca.build_orca_planes(*[jnp.asarray(a) for a in args], 2.0, 0.5)
    normal, point, valid = [np.array(x) for x in pl]
    if kind == "degenerate":
        n1, n2 = normal[:, 1].copy(), normal[:, 2].copy()
        normal[:, 3], point[:, 3] = n1, point[:, 1] - 0.2 * n1
        normal[:, 6], point[:, 6] = -n1, point[:, 1] + 0.8 * n1
        tilt = _unit(np.cross(n2, rng.normal(size=(N, 3))))
        normal[:, 5] = _unit(n2 + 1e-3 * tilt)
        point[:, 5] = point[:, 2] + 0.2 * n2
        normal[:, -2:] = 0.0
        normal[:, -2, 2], normal[:, -1, 2] = 1.0, -1.0
        point[:, -2:] = 0.0
        valid[:, -2:] = True
    return (normal, point, valid), args


def _both(case):
    normal, point, valid = case
    return (jorca.OrcaPlanes(jnp.asarray(normal), jnp.asarray(point),
                             jnp.asarray(valid)),
            torca.OrcaPlanes(_t(normal), _t(point), _t(valid)))


def _close(got, want, tol=TOL, where=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if where is not None:
        got, want = got[where], want[where]
    if got.dtype == bool or np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max(initial=0.0) <= tol


@pytest.mark.parametrize("kind", ["crowd", "degenerate"])
def test_build_orca_planes_matches(kind):
    """The crowd's planes, from both packages (dynamic neighbours take the
    whole avoidance vector), equal; the crowd has colliding pairs."""
    case, args = plane_case("crowd")
    if kind == "degenerate":
        # neighbours exactly at the combined radius, and at rest
        pos, vel = args[0], np.zeros_like(args[1])
        obs = pos[:, None] + 0.5 * _unit(args[3] - pos[:, None])
        args = (pos, vel) + args[2:3] + (obs, np.zeros_like(obs)) + args[5:]
    want = jorca.build_orca_planes(*[jnp.asarray(a) for a in args], 2.0, 0.5)
    got = torca.build_orca_planes(*[_t(a) for a in args], 2.0, 0.5)
    for g, w in zip(got, want):
        _close(g, w)
    if kind == "crowd":
        d2 = ((args[3] - args[0][:, None]) ** 2).sum(-1)
        assert (d2 <= (2 * 0.25) ** 2).sum() >= N


@pytest.mark.parametrize("direction_opt", [False, True])
@pytest.mark.parametrize("kind", ["crowd", "degenerate"])
def test_lp1_lp2_match(kind, direction_opt):
    """lp1 on random lines (some parallel to a plane) and lp2 on random
    planes: ok flags equal everywhere, results where ok; both failing and
    feasible lines occur."""
    rng = np.random.default_rng(1)
    jp, tp = _both(plane_case(kind)[0])
    line_pt = rng.normal(size=(N, 3)) * 0.5
    line_dir = _unit(rng.normal(size=(N, 3)))
    # the first half of the lines run parallel to plane 1
    n1 = np.asarray(jp.normal)[:, 1]
    line_dir[: N // 2] = _unit(np.cross(n1, rng.normal(size=(N, 3))))[: N // 2]
    upto = rng.integers(0, O + 1, N)
    radius = np.full(N, 1.5)
    opt_vel = rng.normal(size=(N, 3))
    jok, jres = jorca._lp1(jp, jnp.asarray(upto), jnp.asarray(line_pt),
                           jnp.asarray(line_dir), jnp.asarray(radius),
                           jnp.asarray(opt_vel), jnp.asarray(direction_opt))
    tok, tres = torca._lp1(tp, _t(upto), _t(line_pt), _t(line_dir),
                           _t(radius), _t(opt_vel), direction_opt)
    _close(tok, jok)
    ok = np.asarray(jok)
    assert ok.any() and not ok.all()
    _close(tres, jres, where=ok)

    plane_no = rng.integers(0, O, N)
    jok, jres = jorca._lp2(jp, jnp.asarray(plane_no), jnp.asarray(radius),
                           jnp.asarray(opt_vel), jnp.asarray(direction_opt))
    tok, tres = torca._lp2(tp, _t(plane_no), _t(radius), _t(opt_vel),
                           direction_opt)
    _close(tok, jok)
    _close(tres, jres)


@pytest.mark.parametrize("kind", ["crowd", "degenerate"])
def test_lp3_lp4_solve_match(kind):
    """lp3 in both optimization modes, lp4 from lp3's failing plane, and
    solve_orca: equal failing planes, results within 1e-12.  lp4 runs for
    at least a quarter of the agents."""
    rng = np.random.default_rng(2)
    jp, tp = _both(plane_case(kind)[0])
    speed = np.full(N, 1.0)
    pref = rng.normal(size=(N, 3))
    for direction_opt in (False, True):
        opt = _unit(pref) if direction_opt else pref
        jf, jr = jorca._lp3(jp, jnp.asarray(speed), jnp.asarray(opt),
                            jnp.asarray(direction_opt))
        tf, tr = torca._lp3(tp, _t(speed), _t(opt), direction_opt)
        _close(tf, jf)
        _close(tr, jr)
    jf, jr = jorca._lp3(jp, jnp.asarray(speed), jnp.asarray(pref),
                        jnp.asarray(False))
    need4 = np.asarray(jf) < O
    assert need4.sum() >= N // 4, need4.sum()
    want = jorca._lp4(jp, jf, jnp.asarray(speed), jr)
    got = torca._lp4(tp, _t(np.asarray(jf)), _t(speed), _t(np.asarray(jr)))
    _close(got, want)
    want = jorca.solve_orca(jp, jnp.asarray(speed), jnp.asarray(pref))
    got = torca.solve_orca(tp, _t(speed), _t(pref))
    _close(got, want)


def _crowd_inputs(seed=3, n=N, spread=0.8):
    rng = np.random.default_rng(seed)
    return dict(pos=rng.uniform(-spread, spread, (n, 3)),
                vel=rng.uniform(-0.5, 0.5, (n, 3)),
                radius=np.full(n, 0.2),
                pref_vel=rng.uniform(-1.0, 1.0, (n, 3)),
                max_speed=np.full(n, 1.0),
                is_dynamic=rng.random(n) < 0.25)


@pytest.mark.parametrize("force_z_zero", [False, True])
def test_orca_velocities_match(force_z_zero):
    """All-agents velocities in f64 (with the 2-D pinning planes too), and
    in f32 within 1e-5 m/s."""
    kw = _crowd_inputs()
    want = np.asarray(jorca.orca_velocities(
        *[jnp.asarray(v) for v in kw.values()], 2.0, 0.5,
        force_z_zero=force_z_zero))
    got = torca.orca_velocities(*[_t(v) for v in kw.values()], 2.0, 0.5,
                                force_z_zero=force_z_zero)
    _close(got, want)
    if force_z_zero:
        # v_z = 0 wherever the LP is feasible (lp4's least penetration may
        # leave the pinning planes)
        assert (np.abs(got[:, 2].numpy()) <= 1e-12).sum() >= N // 2
        return
    f32 = [np.asarray(v, np.float32) if v.dtype == np.float64 else v
           for v in kw.values()]
    want32 = np.asarray(jorca.orca_velocities(
        *[jnp.asarray(v) for v in f32], 2.0, 0.5))
    got32 = torca.orca_velocities(*[torch.as_tensor(v) for v in f32],
                                  2.0, 0.5)
    assert got32.dtype == torch.float32
    _close(got32, want32, tol=1e-5)


def test_neighbour_ties_break_by_lower_index():
    """A circle state where agent 0's 9th and 10th nearest are equally far
    (mirror images across its axis, exactly): at max_neighbors = 9 both
    packages keep the lower index and give the same velocities."""
    n = 16
    theta = 2 * np.pi * np.arange(n // 2 + 1) / n
    pos = np.zeros((n, 3))
    pos[: n // 2 + 1, 0], pos[: n // 2 + 1, 1] = np.cos(theta), np.sin(theta)
    pos[n // 2 + 1:, 0] = pos[1: n // 2][::-1, 0]
    pos[n // 2 + 1:, 1] = -pos[1: n // 2][::-1, 1]
    pos *= 2.0
    d2 = ((pos - pos[0]) ** 2).sum(-1)
    assert d2[5] == d2[n - 5]
    kw = _crowd_inputs(n=n)
    kw["pos"] = pos
    d_sel, nbr = torca.neighbours(_t(pos), 9)
    order = nbr[0].tolist()
    assert 5 in order and n - 5 not in order
    want = np.asarray(jorca.orca_velocities(
        *[jnp.asarray(v) for v in kw.values()], 2.0, 0.5, max_neighbors=9))
    got = torca.orca_velocities(*[_t(v) for v in kw.values()], 2.0, 0.5,
                                max_neighbors=9)
    _close(got, want)


def test_no_neighbors_returns_pref():
    """tests/test_orca.py's lone pair: out of each other's reach, each
    keeps its preferred velocity, as in the JAX package."""
    pos = np.asarray([[0.0, 0, 1], [10.0, 10, 1]])
    pref = np.asarray([[1.0, 0, 0], [0.0, 1, 0]])
    args = (pos, np.zeros((2, 3)), np.full(2, 0.2), pref, np.full(2, 1.0),
            np.zeros(2, bool))
    want = jorca.orca_velocities(*[jnp.asarray(a) for a in args], 2.0, 0.5,
                                 neighbor_dist=5.0)
    got = torca.orca_velocities(*[_t(a) for a in args], 2.0, 0.5,
                                neighbor_dist=5.0)
    _close(got, want)
    np.testing.assert_allclose(got.numpy(), pref, atol=1e-5)


def test_head_on_symmetric_avoidance():
    """tests/test_orca.py's head-on pair (a slight lateral offset): equal
    to JAX's, symmetric, sidestepping, within the speed cap."""
    pos = np.asarray([[-1.0, 0.005, 1], [1.0, -0.005, 1]])
    vel = np.asarray([[1.0, 0, 0], [-1.0, 0, 0]])
    args = (pos, vel, np.full(2, 0.3), vel, np.full(2, 1.0),
            np.zeros(2, bool))
    want = jorca.orca_velocities(*[jnp.asarray(a) for a in args], 2.0, 0.5)
    v = torca.orca_velocities(*[_t(a) for a in args], 2.0, 0.5)
    _close(v, want)
    v = v.numpy()
    np.testing.assert_allclose(v[0, :2], -v[1, :2], atol=1e-4)
    assert v[0, 0] - v[1, 0] < 2.0 - 1e-3
    assert abs(v[0, 1]) > 1e-4
    assert (np.linalg.norm(v, axis=1) <= 1.0 + 1e-5).all()


def test_plane_constraints_satisfied_when_feasible():
    """tests/test_orca.py's random 8 agents: every ORCA plane holds at the
    port's velocities, which equal JAX's."""
    rng = np.random.default_rng(0)
    n = 8
    pos, vel = rng.uniform(-3, 3, (n, 3)), rng.uniform(-0.5, 0.5, (n, 3))
    pref = rng.uniform(-1, 1, (n, 3))
    args = (pos, vel, np.full(n, 0.2), pref, np.full(n, 1.0),
            np.zeros(n, bool))
    want = jorca.orca_velocities(*[jnp.asarray(a) for a in args], 2.0, 0.5)
    v = torca.orca_velocities(*[_t(a) for a in args], 2.0, 0.5)
    _close(v, want)
    d2, nbr = torca.neighbours(_t(pos), 10)
    planes = torca.build_orca_planes(
        _t(pos), _t(vel), _t(args[2]), _t(pos)[nbr], _t(vel)[nbr],
        _t(args[2])[nbr], torch.zeros(nbr.shape, dtype=torch.bool),
        d2 < 225.0, 2.0, 0.5)
    margin = ((v[:, None] - planes.point) * planes.normal).sum(-1)
    assert torch.where(planes.valid, margin, 0.0).min() > -1e-4


def test_solve_dispatches_few_ops():
    """One solve_orca at N = 16, O = 10 dispatches at most 5,000 aten ops
    (the final code: 1,768; the JAX package's nested loops execute 815,345
    primitives there)."""
    jp, tp = _both(plane_case("crowd")[0])
    rng = np.random.default_rng(4)
    speed, pref = _t(np.full(N, 1.0)), _t(rng.normal(size=(N, 3)))

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        torca.solve_orca(tp, speed, pref)
    assert Count.n <= 5000, Count.n


def _rotation(jm, tm, k):
    """Each agent's goal is agent (i + k)'s start (tests/test_orca.py's
    rotational exchange)."""
    for m in (jm, tm):
        starts = [a.start for a in m.agents]
        for qi, a in enumerate(m.agents):
            a.goal = starts[(qi + k) % len(starts)].copy()
    return jm, tm


@pytest.mark.parametrize("goal_mode,extra", [
    (GoalMode.STATIC, {}), (GoalMode.ORCA, {}), (GoalMode.PRIOR_BASED, {}),
    (GoalMode.STATIC, dict(world_dimension=2, world_z_2d=1.0)),
])
def test_orca_cycle_matches_from_jax_state(goal_mode, extra):
    """Each of 12 ORCA cycles of a tight 8-agent rotation from JAX's state
    equals JAX's cycle within 1e-9 m."""
    jp, tp = params(planner_mode=PlannerMode.ORCA, goal_mode=goal_mode,
                    **extra)
    jm, tm = _rotation(*missions("make_circle_mission", 8, radius=1.2,
                                 world=(-3, -3, 0, 3, 3, 2.5)), 3)
    jsim = JSim(jm, jp, dtype=jnp.float64)
    tsim = TSim(tm, tp, dtype=torch.float64)
    errs, _, _ = follow_jax(jsim, tsim, 12)
    assert errs.max() <= 1e-9, errs


def test_rotational_mission_finishes():
    """tests/test_orca.py's 6-agent rotational exchange, flown by each
    package on its own: the port finishes under 400 cycles with safety >
    0.75, within max(20 %, 10) cycles of JAX's f64 run."""
    jp, tp = params(planner_mode=PlannerMode.ORCA, goal_mode=GoalMode.STATIC)
    jm, tm = _rotation(*missions("make_circle_mission", 6, radius=3.0,
                                 world=(-5, -5, 0, 5, 5, 2.5)), 2)
    want = JSim(jm, jp, dtype=jnp.float64).run(max_iterations=400)
    got = TSim(tm, tp, dtype=torch.float64).run(max_iterations=400)
    assert got["iterations"] < 400
    assert got["safety_ratio_agent"] > 0.75
    assert abs(got["iterations"] - want["iterations"]) <= max(
        0.2 * want["iterations"], 10)
